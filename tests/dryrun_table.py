"""A markdown table of a dry-run sweep's cells, one row per (arch, shape),
the single- and multi-pod meshes side by side.

    PYTHONPATH=src python tests/dryrun_table.py results/dryrun_torch [OTHER_DIR]
    PYTHONPATH=src python tests/dryrun_table.py AFTER_DIR --before BEFORE_DIR
    PYTHONPATH=src python tests/dryrun_table.py AFTER_DIR --before BEFORE_DIR --counts [SHAPE]

Each ok cell gives its per-chip arguments plus temporaries (GiB, and the
share of an 80 GiB card), its collectives per chip (GB) and its plan
seconds, from the JSON files ``python -m repro_torch.launch.dryrun``
writes.  With a second directory (the same sweep under another torch), a
cell whose bytes or collectives differ from it by more than 1% is marked
``*``, and the marked cells are counted.  The last line counts the cells
by status and sums the plan seconds.  With ``--before`` each cell gives
both sweeps' GiB and collectives instead (before -> after), the
collectives' ratio, and ``!`` where they rose more than 2x; with
``--counts`` each ok cell (of ``SHAPE`` only, where given) whose FLOPs,
bytes accessed, temporaries or collectives per chip differ, each count
exact (``=`` where it did not move), then how many cells moved.
"""
import json
import sys
from collections import Counter
from pathlib import Path

HBM = 80 * 2**30


def cells(directory):
    out = {}
    for path in sorted(Path(directory).glob("*.json")):
        r = json.loads(path.read_text())
        out[(r["arch"], r["shape"], r["mesh"])] = r
    return out


def _size(r):
    m = r["memory_analysis"]
    return m["argument_bytes"] + m["temp_bytes"], r["collectives"]["total_per_chip_bytes"]


def _differs(r, other) -> bool:
    if other is None or other.get("status") != "ok":
        return False
    return any(abs(a - b) > 0.01 * max(abs(b), 1) for a, b in zip(_size(r), _size(other)))


def before_after(after, before) -> None:
    print("| arch | shape | single: GiB / coll GB, before -> after | multi: GiB / coll GB, before -> after |")
    print("| --- | --- | --- | --- |")
    for arch, shape in sorted({(a, s) for a, s, _ in after}):
        entries = []
        for mesh in ("single", "multi"):
            a, b = after.get((arch, shape, mesh)), before.get((arch, shape, mesh))
            if a is None or b is None or "ok" not in (a["status"], b["status"]):
                entries.append(a["status"] if a else "-")
                continue
            if a["status"] != "ok" or b["status"] != "ok":
                entries.append(f"{b['status']} -> {a['status']}")
                continue
            (sa, ca), (sb, cb) = _size(a), _size(b)
            ratio = ca / cb if cb else float("inf") if ca else 1.0
            entries.append(f"{sb / 2**30:.2f} -> {sa / 2**30:.2f} / {cb / 1e9:.2f} -> {ca / 1e9:.2f} "
                           f"({ratio:.2f}x){' !' if ratio > 2 else ''}")
        if all(e == "skipped" for e in entries):
            continue
        print(f"| {arch} | {shape} | {entries[0]} | {entries[1]} |")


#: a cell's exact counts per chip that ``--counts`` compares
COUNTS = {"flops": lambda r: r["flops_per_chip"], "bytes accessed": lambda r: r["bytes_accessed_per_chip"],
          "temp bytes": lambda r: r["memory_analysis"]["temp_bytes"],
          "collective bytes": lambda r: r["collectives"]["total_per_chip_bytes"]}


def counts_before_after(after, before, shape=None) -> None:
    print("| arch | shape | mesh | " + " | ".join(f"{k}, before -> after" for k in COUNTS) + " |")
    print("| --- | --- | --- |" + " --- |" * len(COUNTS))
    moved = compared = 0
    for key in sorted(after):
        a, b = after[key], before.get(key)
        if (shape and key[1] != shape) or b is None or a["status"] != "ok" or b["status"] != "ok":
            continue
        compared += 1
        pairs = [(get(b), get(a)) for get in COUNTS.values()]
        if all(x == y for x, y in pairs):
            continue
        moved += 1
        print(f"| {' | '.join(key)} | " + " | ".join("=" if x == y else f"{x:,} -> {y:,} ({y / x:.4f}x)"
                                                    for x, y in pairs) + " |")
    print(f"\n{moved} of {compared} ok cells moved")


def main(argv) -> None:
    if "--before" in argv:
        i = argv.index("--before")
        if "--counts" in argv:
            j = argv.index("--counts")
            counts_before_after(cells(argv[0]), cells(argv[i + 1]), argv[j + 1] if j + 1 < len(argv) else None)
            return
        before_after(cells(argv[0]), cells(argv[i + 1]))
        return
    main_cells = cells(argv[0])
    other = cells(argv[1]) if len(argv) > 1 else {}
    print("| arch | shape | single: GiB (of 80) / coll GB / plan s | multi: GiB (of 80) / coll GB / plan s |")
    print("| --- | --- | --- | --- |")
    rows = sorted({(a, s) for a, s, _ in main_cells})
    for arch, shape in rows:
        entries = []
        for mesh in ("single", "multi"):
            r = main_cells.get((arch, shape, mesh))
            if r is None or r["status"] != "ok":
                entries.append(r["status"] if r else "-")
                continue
            size, coll = _size(r)
            mark = " *" if _differs(r, other.get((arch, shape, mesh))) else ""
            entries.append(f"{size / 2**30:.2f} ({size / HBM:.0%}) / {coll / 1e9:.1f} / {r['plan_seconds']:.2f}{mark}")
        if all(e == "skipped" for e in entries):
            continue
        print(f"| {arch} | {shape} | {entries[0]} | {entries[1]} |")
    if other:
        marked = sum(_differs(r, other.get(k)) for k, r in main_cells.items() if r["status"] == "ok")
        print(f"\n{marked} of {sum(r['status'] == 'ok' for r in main_cells.values())} ok cells differ by more "
              f"than 1% from {argv[1]}")
    status = Counter(r["status"] for r in main_cells.values())
    total = sum(r.get("plan_seconds", 0) for r in main_cells.values() if r["status"] == "ok")
    print(f"\n{dict(status)}; plan seconds summed over the ok cells {total:.1f}")


if __name__ == "__main__":
    main(sys.argv[1:])
