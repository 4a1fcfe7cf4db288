"""The port's sharding specs and activation anchors against the JAX
package's.

For every arch of ``configs/registry.py::ARCHS`` at its published size
(the spec functions allocate nothing) and each of the three sharding
policies, ``param_specs`` and ``cache_specs`` (with and without
``seq_axes``, ``model_on_heads`` both ways) equal the JAX package's leaf
by leaf, keys included.  On the reduced configs every parameter of the
port's ``LM`` has a spec, and no spec is longer than its leaf's rank.
With no mesh the activation anchors return their input; a mesh raises.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from jax.sharding import PartitionSpec as JP  # noqa: E402

import repro.models as jm  # noqa: E402
from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_reduced as j_reduced  # noqa: E402
from repro.models import layers as jl  # noqa: E402
import repro_torch.models as tm  # noqa: E402
from repro_torch.configs import ARCHS, get_config, get_reduced  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import sharding as ts  # noqa: E402

POLICIES = ["2d", "fsdp", "tp_only"]
SEQ_AXES = [None, "data", ("pod", "data")]


@pytest.fixture
def policy(request):
    """Both packages under one sharding policy, the default restored."""
    jl.set_sharding_policy(request.param)
    tl.set_sharding_policy(request.param)
    try:
        yield request.param
    finally:
        jl.set_sharding_policy("2d")
        tl.set_sharding_policy("2d")


def _jax_tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, JP))


def _port_tuples(tree):
    if isinstance(tree, ts.P):
        return tuple(tree)
    assert isinstance(tree, dict), type(tree)
    return {k: _port_tuples(v) for k, v in tree.items()}


def test_registries_agree():
    assert ARCHS == J_ARCHS


@pytest.mark.parametrize("policy", POLICIES, indirect=True)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_cache_specs_equal_jax(arch, policy):
    assert tl.get_sharding_policy() == jl.get_sharding_policy() == policy
    jcfg, tcfg = j_config(arch), get_config(arch)
    assert _port_tuples(tm.param_specs(tcfg)) == _jax_tuples(jm.param_specs(jcfg))
    for seq_axes in SEQ_AXES:
        for on_heads in (True, False):
            assert (_port_tuples(tm.cache_specs(tcfg, seq_axes, on_heads))
                    == _jax_tuples(jm.cache_specs(jcfg, seq_axes, on_heads))), (seq_axes, on_heads)


@pytest.mark.parametrize("policy", POLICIES, indirect=True)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_cover_reduced_params(arch, policy):
    cfg = get_reduced(arch, dtype="float32")
    tree = tm.params_to_numpy(tm.init_params(0, cfg, device="cpu"))
    specs = tm.param_specs(cfg)

    def walk(t, s, where):
        assert isinstance(s, dict) and set(t) == set(s), where
        for k in t:
            if isinstance(t[k], dict):
                walk(t[k], s[k], f"{where}.{k}")
            else:
                assert isinstance(s[k], ts.P) and len(s[k]) <= t[k].ndim, (f"{where}.{k}", s[k], t[k].shape)

    walk(tree, specs, "params")


@pytest.mark.parametrize("name", ["matrix", "replicated"])
def test_matrix_and_replicated_spec_equal_jax(name):
    shapes = [(64, 128), (128, 64), (8, 64, 32), (7,), (3, 3)]
    for policy in POLICIES:
        jl.set_sharding_policy(policy)
        tl.set_sharding_policy(policy)
        try:
            for shape in shapes:
                if name == "replicated":
                    assert tuple(tl.replicated_spec(shape)) == tuple(jl.replicated_spec(shape))
                    continue
                for tp_dim in [None] + list(range(len(shape))):
                    assert tuple(tl.matrix_spec(shape, tp_dim)) == tuple(jl.matrix_spec(shape, tp_dim))
        finally:
            jl.set_sharding_policy("2d")
            tl.set_sharding_policy("2d")
    with pytest.raises(ValueError, match="policy"):
        tl.set_sharding_policy("3d")


def test_partition_spec_entries_canonical_as_jax():
    for entries in [(), (None,), (("model",),), (["pod", "data"], None), ((), "model"),
                    (("pod", "data"), None, "model", None)]:
        assert tuple(ts.P(*entries)) == tuple(JP(*entries)), entries


def test_anchors_are_identities_without_a_mesh():
    x = torch.randn(2, 5, 8)
    assert ts.shard_batch(x) is x
    assert ts.shard_logits(x) is x
    assert ts.shard_moe_buffer(x) is x
    assert ts.shard_heads(x.reshape(2, 5, 2, 4), head_axis=2).shape == (2, 5, 2, 4)
    with ts.activation_mesh(None, ("data",)):
        assert ts.shard_batch(x) is x
    # under a device mesh too: a data shard's program holds only its rows
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"])
    with ts.activation_mesh(mesh, ("data",)):
        assert ts.ambient_mesh() == (mesh, ("data",))
        assert ts.shard_batch(x) is x and ts.shard_logits(x) is x and ts.shard_moe_buffer(x) is x
        assert mesh.run(lambda t: ts.shard_batch(t) is t, [(x[:1],), (x[1:],)], ("data",)) == [True, True]
    assert ts.ambient_mesh() == (None, ())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_counts_equal_jax(arch):
    jcfg, tcfg = j_config(arch), get_config(arch)
    assert tm.param_count_analytic(tcfg) == jm.param_count_analytic(jcfg)
    assert tm.active_param_count(tcfg) == jm.active_param_count(jcfg)
    cfg = get_reduced(arch, dtype="float32")
    assert tm.count_params(tm.init_params(0, cfg, device="cpu")) == tm.param_count_analytic(cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v2-236b", "zamba2-2.7b", "hubert-xlarge"])
def test_params_to_numpy_inverts_params_from_numpy(arch, dtype):
    """The JAX tree → the port → the JAX tree: the same keys, shapes and
    values (bf16 leaves come back as f32 arrays of the same values), and
    the port's parameters again to the bit."""
    jcfg = j_reduced(arch, dtype=dtype)
    tcfg = get_reduced(arch, dtype=dtype)
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(2), jcfg))
    params = tm.params_from_numpy(tree, tcfg, "cpu")
    back = tm.params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    again = tm.params_from_numpy(back, tcfg, "cpu")
    for (n, a), (_, b) in zip(params.named_parameters(), again.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), n
