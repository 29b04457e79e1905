"""Every local op of one dry-run cell's step, in order, and the difference
between two such traces: where two torch versions plan a cell apart.

    PYTHONPATH=src python tests/dryrun_trace.py ARCH SHAPE [--mesh single|multi] [--layers N] --out FILE
    python tests/dryrun_trace.py --diff FILE_A FILE_B [--blocks 15]

The cell's step runs on DTensors over the production mesh on ``meta`` as
``repro_torch.launch.dryrun.plan_cell`` runs it, at ``--layers`` layers
(default two layer groups; the plan runs two and three groups and the
tail layers, ``dryrun._stacks``), with ``StepCount`` 's memo off.  Each
line of the trace is one local op: its name, its outputs' dtypes and
local shapes, for a collective its kind, group size and operand shape,
the bytes of the storages alive after it, and the innermost line of the
port's model or train code on the stack.  The first line holds the torch
version and the run's counts.  ``--diff`` aligns two traces without the
live bytes and prints the blocks where they differ, then each collective
(kind, group size, operand, source line) whose count differs.
"""
import argparse
import collections
import difflib
import gzip
import re
import sys
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _source_line() -> str:
    for fr in reversed(traceback.extract_stack()[:-3]):
        if "repro_torch/models" in fr.filename or "repro_torch/train" in fr.filename:
            return f"{fr.filename.split('repro_torch/')[1]}:{fr.lineno}"
    return "-"


def trace(arch: str, shape: str, mesh_kind: str, layers, out: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import fake_device_mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    class Trace(dryrun.StepCount):
        def start(self, args):
            super().start(args)
            self.lines = []

        def _memo_key(self, *args):
            return None  # no replay: every op runs where it is traced

        def _local_op(self, func, args, kwargs):
            result = super()._local_op(func, args, kwargs)
            shapes = " ".join(f"{str(dryrun._local(t).dtype)[6:]}{list(dryrun._local(t).shape)}"
                              for t in dryrun._tensors(result))
            kind = dryrun.collective_kind(func)
            if kind is not None:
                group = dist.distributed_c10d._resolve_process_group([a for a in args if isinstance(a, str)][-1])
                shapes += f" {kind} group={group.size()} in={list(dryrun._local(args[0]).shape)}"
            self.lines.append(f"{func._schema.name.split('::')[1]} {shapes} live={self._live.now} @{_source_line()}")
            return result

    cfg = get_config(arch)
    cfg = cfg.scaled(n_layers=layers or 2 * len(cfg.block_pattern))
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device="meta")
    with fake_device_mesh(mesh) as device_mesh:
        counter = Trace()
        counts, _ = dryrun.count_step(counter, *dryrun.cell_step(cfg, shape, mesh, device_mesh))
    with open(out, "w") as f:
        f.write(f"torch {torch.__version__} {arch} {shape} {mesh_kind} {cfg.n_layers} layers: {counts}\n")
        f.write("\n".join(counter.lines) + "\n")
    print(out, len(counter.lines), {k: v for k, v in counts.items() if k.endswith("_bytes")})


def _read(path: str):
    lines = (gzip.open if path.endswith(".gz") else open)(path, "rt").read().splitlines()
    return lines[0], lines[1:]


def diff(a_path: str, b_path: str, blocks: int) -> None:
    (head_a, a), (head_b, b) = _read(a_path), _read(b_path)
    print(head_a[:400], head_b[:400], sep="\n")
    strip = [[re.sub(r" live=\d+", "", line) for line in t] for t in (a, b)]
    ops = [op for op in difflib.SequenceMatcher(None, *strip, autojunk=False).get_opcodes() if op[0] != "equal"]
    for tag, i1, i2, j1, j2 in ops[:blocks]:
        print(f"--- {tag} A[{i1}:{i2}] B[{j1}:{j2}]")
        print("\n".join(f"  A {line[:240]}" for line in a[i1:min(i2, i1 + 8)]))
        print("\n".join(f"  B {line[:240]}" for line in b[j1:min(j2, j1 + 8)]))
    print(f"{len(ops)} blocks differ")

    def collectives(t):
        return collections.Counter(re.sub(r"^\S+ \S+ (.*) live=\d+ (@\S+)$", r"\1 \2", line) for line in t
                                   if " group=" in line)

    ca, cb = collectives(a), collectives(b)
    for key in sorted(set(ca) | set(cb)):
        if ca[key] != cb[key]:
            print(f"collective {key}: A {ca[key]}, B {cb[key]}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("arch", nargs="?")
    ap.add_argument("shape", nargs="?")
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--out")
    ap.add_argument("--diff", nargs=2, metavar=("A", "B"))
    ap.add_argument("--blocks", type=int, default=15)
    args = ap.parse_args(argv)
    if args.diff:
        diff(*args.diff, args.blocks)
    else:
        trace(args.arch, args.shape, args.mesh, args.layers, args.out)


if __name__ == "__main__":
    main()
