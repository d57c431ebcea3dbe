"""Launchers: ``train`` (the fault-tolerant training loop), ``serve`` (the
serving gateway over a Poisson workload) and ``specs`` (meta-tensor
stand-ins for every model input)."""
