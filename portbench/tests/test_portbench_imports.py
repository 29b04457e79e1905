"""Nothing the benchmark runs loads JAX or the JAX package: top-level
module names are compared whole (``repro_torch`` is not ``repro``)."""
import subprocess
import sys

from portbench import harness, spec

FORBIDDEN = repr(harness.FORBIDDEN)


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=spec.ROOT, capture_output=True, text=True, check=True,
        env={"PYTHONPATH": f"{spec.ROOT / 'src'}:{spec.ROOT}", "PATH": "/usr/bin:/bin"},
    )
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _loaded(
        "import portbench.run, portbench.harness, portbench.control\n"
        "import portbench.entries.simulation, portbench.entries.sharded\n"
        "import repro_torch.pic, repro_torch.dist"
    )
    assert "repro_torch" in names
    assert not names & set(harness.FORBIDDEN), names & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    names = _loaded(
        "import portbench.reference.pic, portbench.reference.compare, portbench.inputs, "
        "portbench.domains.pic"
    )
    assert not names & ({"repro_torch"} | set(harness.FORBIDDEN))
