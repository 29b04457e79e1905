"""The port's sharding rules (``repro_torch.dist.sharding``) against the
reference's (``repro.dist.sharding``), exactly.

The rules are pure logic, so both packages run on fake meshes: the
reference's ``jax.sharding.AbstractMesh`` over the production layouts
(16x16 ``("data", "model")`` and 2x16x16 ``("pod", "data", "model")``,
no devices needed) and the port's ``make_production_mesh(device="meta")``.
Specs are compared as tuples (jax 0.9's ``PartitionSpec`` stores a
one-name tuple entry as the name, as the port's ``P`` does), and every
leaf's shard shape with it, for the full-size params of all ten configs.
Placement (``device_put``, ``gather``, ``bytes_per_device``) runs on a
(2, 2) mesh of ``"cpu"`` logical devices, bitwise.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.dist import sharding as ref
from repro.models import init_params as ref_init_params
from repro_torch.ckpt.checkpoint import _flatten, _keystr
from repro_torch.configs import get_config
from repro_torch.dist import sharding as port
from repro_torch.launch.dryrun import per_chip_bytes
from repro_torch.launch.mesh import make_box_mesh, make_mesh, make_production_mesh
from repro_torch.models import init_params

MESHES = {
    "single": (((16, 16), ("data", "model")), False),
    "multi": (((2, 16, 16), ("pod", "data", "model")), True),
}


class _FakeMesh:
    axis_names = ("data", "model")
    shape = {"data": 4, "model": 2}


def _meshes(kind):
    (shape, names), multi = MESHES[kind]
    return AbstractMesh(shape, names), make_production_mesh(multi_pod=multi, device="meta")


def ref_param_tree(cfg):
    """The reference's param shapes and logical axes, with no compile (its
    dry run's ``init_params_spec_only``)."""
    closure = {}

    def build():
        p, s = ref_init_params(jax.random.PRNGKey(0), cfg)
        closure["specs"] = s
        return p

    return jax.eval_shape(build), closure["specs"]


def ref_flat(tree):
    return {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_flat(tree):
    return {_keystr(k): v for k, v in _flatten(tree)}


def assert_same_shardings(ref_sh, ref_shapes, port_sh, port_shapes):
    """Leaf for leaf: the same paths, specs and shard shapes."""
    r, rs = ref_flat(ref_sh), ref_flat(ref_shapes)
    p, ps = port_flat(port_sh), port_flat(port_shapes)
    assert sorted(r) == sorted(p)
    for k in r:
        assert tuple(rs[k].shape) == tuple(ps[k].shape), k
        assert tuple(r[k].spec) == tuple(p[k].spec), k
        assert tuple(r[k].shard_shape(rs[k].shape)) == p[k].shard_shape(ps[k].shape), k


# ---------------------------------------------------------------------------
# spec_for fallbacks (tests/test_infra.py, tests/test_dist_runtime.py)
# ---------------------------------------------------------------------------


SPEC_CASES = [
    # divisible: sharded; not divisible: that dim replicated; one axis, one dim
    (("vocab", "embed"), (10, 8), "infra"),
    (("vocab", "embed"), (7, 8), "infra"),
    (("vocab", "heads_x_hd"), (8, 8), "infra"),
    # a tuple rule shards over the product extent, or replicates
    (("batch", None), (8, 3), "tuple"),
    (("batch", None), (12, 3), "tuple"),
    # single use applies to tuple rules, in dim order
    (("batch", "vocab"), (8, 4), "single_use"),
    (("vocab", "batch"), (4, 8), "single_use"),
    # unknown axes replicate
    (("nonexistent", None), (8, 3), "unknown"),
]
RULES = {
    "infra": {"batch": ("data",), "vocab": "model", "embed": "data", None: None,
              "heads_x_hd": "model"},
    "tuple": {None: None, "batch": ("data", "model"), "embed": "data"},
    "single_use": {None: None, "batch": ("data", "model"), "vocab": "model"},
    "unknown": {None: None},
}
SPEC_EXPECTED = [
    ("model", "data"), (None, "data"), ("model", None), (("data", "model"), None),
    (None, None), (("data", "model"), None), ("model", None), (None, None),
]


@pytest.mark.parametrize("i", range(len(SPEC_CASES)))
def test_spec_for_fallbacks_match_reference(i):
    axes, shape, rules = SPEC_CASES[i]
    got = port.spec_for(axes, shape, RULES[rules], _FakeMesh())
    assert got == port.P(*SPEC_EXPECTED[i])
    assert tuple(got) == tuple(ref.spec_for(axes, shape, RULES[rules], _FakeMesh()))


def test_p_normalizes_entries_as_jax():
    for entries in [(), (None, None), (("data",), None), (("data", "model"),), ((),), ("model",)]:
        assert tuple(port.P(*entries)) == tuple(JP(*entries)), entries
    assert port.P() != port.P(None, None)


def test_batch_sharding_shape_fallback():
    """global_batch not divisible by the data axes (batch=1 decode)
    replicates; a 0-d shape gives P()."""
    mesh = make_mesh((2, 1), ("data", "model"), device="cpu")
    rules = port.default_rules(mesh)
    assert port.batch_sharding(mesh, rules, shape=(4, 16)).spec == port.P(("data",), None)
    assert port.batch_sharding(mesh, rules, shape=(1, 16)).spec == port.P()
    assert port.batch_sharding(mesh, rules, shape=()).spec == port.P()
    amesh = AbstractMesh((2, 1), ("data", "model"))
    arules = ref.default_rules(amesh)
    for shape in [(4, 16), (1, 16), (), (6, 3, 2), None]:
        assert tuple(port.batch_sharding(mesh, rules, shape=shape).spec) == tuple(
            ref.batch_sharding(amesh, arules, shape=shape).spec), shape


def test_runtime_rules_and_state_shardings():
    """Slot-major state shards dim 0 over the box axis (the box mesh is
    ``make_box_mesh``'s tuple of devices), and degrades to replication on
    a mesh without one."""
    mesh = make_box_mesh(1, device="cpu")
    state = (torch.zeros((4, 6, 8, 8)), ({"z": torch.zeros((4, 16)), "s": torch.zeros(())},), None)
    sh = port.state_shardings(state, mesh)
    assert sh[0].spec == port.P("boxes", None, None, None)
    assert sh[1][0]["z"].spec == port.P("boxes", None)
    assert sh[1][0]["s"].spec == port.P()
    assert sh[2] is None
    # four slots over three devices: not divisible, replicated
    assert port.state_shardings(state, make_box_mesh(3, device="cpu"))[0].spec == port.P(
        None, None, None, None)

    other = make_mesh((1, 1), ("data", "model"), device="cpu")
    assert port.runtime_rules(other)["boxes"] is None
    assert port.state_shardings(state, other)[0].spec == port.P(None, None, None, None)

    # the reference on the same layouts
    jstate = jax.tree.map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape), np.float32), state)
    for ports, amesh in [(mesh, AbstractMesh((1,), ("boxes",))),
                         (make_box_mesh(3, device="cpu"), AbstractMesh((3,), ("boxes",))),
                         (other, AbstractMesh((1, 1), ("data", "model")))]:
        assert port.runtime_rules(ports) == ref.runtime_rules(amesh)
        got = [tuple(s.spec) for s in jax.tree.leaves(
            port.state_shardings(state, ports), is_leaf=lambda x: isinstance(x, port.NamedSharding))]
        want = [tuple(s.spec) for s in jax.tree.leaves(ref.state_shardings(jstate, amesh))]
        assert got == want


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("expert_sharding", ["tp", "ep"])
def test_default_rules_match_reference(kind, expert_sharding):
    amesh, pmesh = _meshes(kind)
    assert port.default_rules(pmesh, expert_sharding=expert_sharding) == ref.default_rules(
        amesh, expert_sharding=expert_sharding)


# ---------------------------------------------------------------------------
# the full-size param trees of every config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shardings_match_reference(arch, kind):
    """Every leaf's spec and shard shape on the production meshes, with the
    config's own expert sharding and with 'ep' (which no config sets)."""
    amesh, pmesh = _meshes(kind)
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    ref_shapes, ref_axes = ref_param_tree(rcfg)
    params, axes = init_params(None, cfg, device="meta")
    for es in sorted({cfg.expert_sharding, "ep"}):
        ref_sh = ref.tree_shardings(ref_axes, ref_shapes, amesh, ref.default_rules(amesh, expert_sharding=es))
        port_sh = port.tree_shardings(axes, params, pmesh, port.default_rules(pmesh, expert_sharding=es))
        assert_same_shardings(ref_sh, ref_shapes, port_sh, params)


@pytest.mark.parametrize("arch,want", [
    # 16 experts over 'model' (16): expert parallel, the ff dim replicated
    ("llama4-scout-17b-a16e", (None, "model", "data", None)),
    # 8 experts do not divide: replicated, and ff takes 'model' as under 'tp'
    ("mixtral-8x7b", (None, None, "data", "model")),
])
def test_expert_parallel_rule_and_its_fallbacks(arch, want):
    _, pmesh = _meshes("single")
    params, axes = init_params(None, get_config(arch), device="meta")
    sh = port.tree_shardings(axes, params, pmesh, port.default_rules(pmesh, expert_sharding="ep"))
    assert tuple(sh["blocks"]["a0"]["ff"]["w_gate"].spec) == want


# ---------------------------------------------------------------------------
# placement over logical devices
# ---------------------------------------------------------------------------


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.element_size() == 2 else t.view(torch.int32)


@pytest.mark.parametrize("arch", ["yi-9b", "mixtral-8x7b"])
def test_device_put_and_gather_real_param_tree(arch):
    """The counterpart of ``test_tree_shardings_place_real_param_tree``: a
    SMOKE param tree placed over 2x2 ``"cpu"`` logical devices gathers back
    bitwise, every block a contiguous tensor of its own, and each
    position's bytes are the per-chip bytes the shardings give."""
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    cfg = get_config(arch, smoke=True)
    params, axes = init_params(0, cfg, device="cpu")
    rules = port.default_rules(mesh, expert_sharding=cfg.expert_sharding)
    shardings = port.tree_shardings(axes, params, mesh, rules)
    placed = port.device_put(params, shardings)
    back = port.gather(placed)
    flat, got = port_flat(params), port_flat(back)
    assert sorted(flat) == sorted(got)
    for k, t in flat.items():
        assert got[k].dtype == t.dtype and torch.equal(_bits(got[k]), _bits(t)), k
    shards = [s for v in port_flat(placed).values() for s in v.shards.flat]
    assert all(s.is_contiguous() and s.untyped_storage().nbytes() == s.nbytes for s in shards)
    per_dev = port.bytes_per_device(placed)
    assert per_dev.shape == (2, 2)
    assert (per_dev == per_chip_bytes(params, shardings)).all()
    sharded = [k for k, v in port_flat(placed).items() if any(e is not None for e in v.sharding.spec)]
    assert sharded  # the mesh really splits the tree

    bs = port.batch_sharding(mesh, port.default_rules(mesh), shape=(4, 16))
    tok = torch.arange(64, dtype=torch.int32).reshape(4, 16)
    placed_tok = port.device_put(tok, bs)
    assert placed_tok.shards[1, 0].shape == (2, 16)
    assert torch.equal(placed_tok.shards[1, 1], tok[2:])
    assert torch.equal(port.gather(placed_tok), tok)
