"""FLOP and byte accounting on the H100: ``roofline`` (the card's peaks,
the hand kernels' bounds, the model's FLOPs) and ``op_analysis`` (a step's
work counted op by op)."""
