"""The matrix products of one JAX dry-run cell, per rank, by shape (CPU only).

Lowers and compiles one (arch x shape) cell of the JAX package on its
production mesh of placeholder host devices, as ``python -m
repro.launch.dryrun`` does, and walks the compiled program (each while
loop's body counted its trip count of times, as ``repro.analysis.
hlo_analysis`` counts it) for its ``dot`` instructions. Prints one JSON
line: the dot FLOPs per rank and, for each product by operand and output
shapes, its count and FLOPs, largest first. The port's counterpart is
``op_analysis``' ``by_product`` in ``python -m repro_torch.launch.dryrun``.
It reads the JAX package and changes nothing in it.

    python scripts/jax_cell_dots.py --arch jamba-1.5-large-398b --shape long_500k
"""
from __future__ import annotations

import argparse
import collections
import json
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

# first: sets the placeholder host device count before JAX starts
import repro.launch.dryrun  # noqa: E402,F401
from repro.analysis import hlo_analysis as H  # noqa: E402


def dots(txt: str) -> dict:
    comps, entry = H.parse_hlo(txt)
    found = collections.defaultdict(lambda: [0, 0.0])

    def walk(name: str, mult: float) -> None:
        comp = comps.get(name)
        if comp is None:
            return
        for ins in comp.instrs:
            if ins.opcode == "dot":
                shapes = [comp.by_name[o].shape.split("{")[0] for o in ins.operands[:2]
                          if o in comp.by_name]
                key = f"{' @ '.join(shapes)} -> {ins.shape.split('{')[0]}"
                found[key][0] += int(mult)
                found[key][1] += H._dot_flops(ins, comp) * mult
            subs = re.findall(r"(?:body|calls|to_apply|branch_computations)=\{?%?([\w.\-]+)",
                              ins.attrs)
            trips = 1
            if ins.opcode == "while":
                tm = H._TRIP_RE.search(ins.attrs)
                trips = int(tm.group(1)) if tm else 1
            for sub in subs:
                walk(sub, mult * trips)

    walk(entry, 1.0)
    rows = sorted(found.items(), key=lambda kv: -kv[1][1])
    return {"dot_flops": sum(f for _, f in found.values()),
            "by_product": {k: {"count": n, "flops": f} for k, (n, f) in rows}}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args()
    from repro.distributed.act_sharding import activation_policy
    from repro.launch.cells import build_cell
    from repro.launch.mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=args.multi_pod)
    jitted, cell_args, meta = build_cell(args.arch, args.shape, mesh)
    with mesh:
        with activation_policy(meta.get("policy")):
            lowered = jitted.lower(*cell_args)
        compiled = lowered.compile()
    print(json.dumps({"arch": args.arch, "shape": args.shape,
                      "mesh": "2x16x16" if args.multi_pod else "16x16",
                      **dots(compiled.as_text())}))


if __name__ == "__main__":
    main()
