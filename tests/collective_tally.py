"""The collectives of one dry-run cell, op by op: which op of the port's
step issues each collective of a kind, and how many bytes (or, with
``--kind flops``, which ops compute the FLOPs per chip).

    PYTHONPATH=src python tests/collective_tally.py llama4-scout-17b-a16e train_4k \
        [--kind reduce-scatter|...|flops] [--groups 2] [--mesh single|multi] [--top 20]

The cell's step runs on DTensors over the production mesh on ``meta``, as
``repro_torch.launch.dryrun.plan_cell`` runs it, at ``--groups`` layer
groups per stack (the plan extends two and three groups to the full
depth), with ``StepCount`` 's memo off so that every op is counted where it
runs.  Each collective of ``--kind`` is put under the DTensor op that
issued it (``redistribute`` for an explicit or autograd redistribution),
the autograd node running it (``-`` in the forward), its operand's local
shape and dtype, and the port's innermost source lines on the stack.
Prints the rows by bytes, each with its count and share, and the totals.
"""
import argparse
import collections
import sys
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.dist.sharding import fake_device_mesh  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402


class Tally(dryrun.StepCount):
    """``StepCount`` with each collective of ``kind`` (or each op's FLOPs)
    put under its op."""

    def __init__(self, kind: str):
        super().__init__()
        self.kind = kind
        self.bytes = collections.Counter()
        self.count = collections.Counter()
        self._outer = []

    def _memo_key(self, func, kind, args, kwargs):
        return None  # no replay: every collective is issued where it is counted

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types) and not self._pass:
            self._outer.append(func)
            try:
                return super().__torch_dispatch__(func, types, args, kwargs)
            finally:
                self._outer.pop()
        return super().__torch_dispatch__(func, types, args, kwargs)

    def _local_op(self, func, args, kwargs):
        if self.kind == "flops":
            before = self.c["flops"]
            out = super()._local_op(func, args, kwargs)
            if self.c["flops"] > before:
                self._add(str(func), args, self.c["flops"] - before)
            return out
        if dryrun.collective_kind(func) == self.kind:
            self._add(str(self._outer[-1]) if self._outer else "redistribute", args, dryrun._nbytes(args[0]))
        return super()._local_op(func, args, kwargs)

    def _add(self, op, args, amount):
        node = torch._C._current_autograd_node()
        frames = [f for f in traceback.extract_stack()
                  if "repro_torch" in f.filename and "launch/dryrun" not in f.filename]
        where = " < ".join(f"{f.filename.split('repro_torch/')[-1]}:{f.lineno}" for f in frames[::-1][:3])
        operand = dryrun._local(args[0])
        key = (op, node.name() if node is not None else "-", tuple(operand.shape), str(operand.dtype), where)
        self.bytes[key] += amount
        self.count[key] += 1


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("arch", choices=ARCH_IDS)
    ap.add_argument("shape", choices=tuple(SHAPES))
    ap.add_argument("--kind", choices=(*dryrun.COLLECTIVE_KINDS, "flops"), default="reduce-scatter")
    ap.add_argument("--groups", type=int, default=2)
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    pat = len(cfg.block_pattern)
    cut = cfg.scaled(n_layers=args.groups * pat, **({"n_enc_layers": args.groups} if cfg.kind == "encdec" else {}))
    mesh = make_production_mesh(multi_pod=args.mesh == "multi", device="meta")
    tally = Tally(args.kind)
    with fake_device_mesh(mesh) as device_mesh:
        step, step_args = dryrun.cell_step(cut, args.shape, mesh, device_mesh)
        counts, _ = dryrun.count_step(tally, step, step_args)
    total = sum(tally.bytes.values())
    head = f"{args.arch} {args.shape} {args.mesh} at {args.groups} layer groups, torch {torch.__version__}: "
    if args.kind == "flops":
        print(head + f"{counts['flops']:,} FLOPs per chip")
    else:
        print(head + f"{args.kind} {counts[f'{args.kind}_count']} ops, {counts[f'{args.kind}_bytes']:,} B per chip")
    unit = "F" if args.kind == "flops" else "B"
    for key, b in tally.bytes.most_common(args.top):
        op, node, shape, dtype, where = key
        print(f"{b:>20,} {unit} {tally.count[key]:>5}x {100 * b / max(total, 1):5.1f}%  {op}  {node}  "
              f"{shape} {dtype}  {where}")


if __name__ == "__main__":
    main()
