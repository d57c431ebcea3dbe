"""Quickstart on the PyTorch/CUDA port: declare a GPU function with the
unified API and invoke it, as examples/quickstart.py does for the JAX
package.

One ``FunctionSpec`` describes the function (the knowability property),
the ``Gateway`` lowers it onto the real runtime, where the daemon loads the
weights onto the card while the engine builds the context (the
hand-written kernels), and the second invocation hits the shared read-only
weights and a live context (sharing-based memory management + multi-stage
exit). The served model is the reduced qwen2.5-3b, as in the JAX package;
its attention runs the hand-written flash-attention kernel on the card.

Run:  python examples/torch_quickstart.py                 # on the card
      python examples/torch_quickstart.py --device cpu    # on the CPU
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.api import FunctionSpec, Gateway  # noqa: E402


def main(device: str = "cuda") -> dict:
    """Run the quickstart on ``device``; returns the cold and warm records,
    the daemon's shared hits, the memory usage before shutdown and the
    (shut down) gateway, whose database still holds inputs and outputs."""
    # one gateway per node: SageInit + one memory daemon per device
    gw = Gateway(backend="runtime", policy="sage", time_scale=0.2,
                 exit_ttl=30.0, device=device)

    # a real (reduced) qwen2.5 model becomes a serverless GPU function;
    # declared sizes come from the paper's resnet50 profile (Table 2)
    gw.register(FunctionSpec(name="demo-llm", arch="qwen2.5-3b",
                             profile="resnet50"))

    print(f"cold invocation on {device} (kernel build/load + weight load in parallel)...")
    cold = gw.invoke("demo-llm", seed=0)
    print(f"  -> {cold.result}  e2e={cold.e2e*1e3:.1f}ms  stages="
          f"{ {k: round(v*1e3, 1) for k, v in cold.stages.items()} }")

    print("warm invocation (shared weights + live context)...")
    warm = gw.invoke("demo-llm", seed=1)
    shared_hits = gw.runtime.daemon.stats["shared_hits"]
    memory = gw.memory_usage()
    print(f"  -> e2e={warm.e2e*1e3:.1f}ms  warm_stage={warm.warm_stage}")
    print(f"speedup: {cold.e2e/warm.e2e:.1f}x | shared hits: {shared_hits} | "
          f"device mem: {memory['device_used']/2**20:.0f} MB")
    gw.shutdown()
    return {"cold": cold, "warm": warm, "shared_hits": shared_hits,
            "memory": memory, "gateway": gw}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
