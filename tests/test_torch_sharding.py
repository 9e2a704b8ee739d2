"""The port's partition rules, shapes and input specs against the JAX
package's, on the CPU.

``param_pspecs`` on all ten architectures on (16, 16), (2, 16, 16) and
(4, 4) abstract meshes, with and without the LLCG group axis; the decode
state rules (``launch.dryrun._state_pspecs``) on every decode-capable
architecture's ``decode_32k`` states on both production meshes;
``batch_pspec`` in every flag combination; ``_fix_divisibility``;
``SHAPES``; the train / prefill / decode input specs (shapes and dtypes,
frontends included); ``shape_supported`` over all 40 pairs; and a
rank's block of a tensor under a spec.  Specs are the contents of a JAX
``PartitionSpec``, so they compare as tuples.  Nothing is allocated: both
packages' trees are abstract.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax
from jax.sharding import AbstractMesh, PartitionSpec

from repro import configs as jconfigs
from repro.distributed import sharding as jsharding
from repro.launch.dryrun import _state_pspecs as jstate_pspecs
from repro.models.transformer.model import LM as JLM
from repro_torch import configs
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.models.transformer.model import LM

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x4": ((4, 4), ("data", "model"))}
ARCHS = configs.ARCH_IDS


def _meshes(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), sharding.MeshSpec(sizes, names)


def _key(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                    for k in path)


def _jspecs(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {_key(p): tuple(s) for p, s in flat}


def _pspecs(tree) -> dict:
    return {"/".join(n): s for n, s in sharding._paths(tree)}


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    return jax.eval_shape(JLM(jconfigs.get_config(arch)).init,
                          jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _params(arch):
    return LM(configs.get_config(arch)).param_specs()


def test_arch_registry_matches():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_jax(arch, mesh):
    jmesh, pmesh = _meshes(mesh)
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    jshapes, shapes = _jparams(arch), _params(arch)
    want_shapes = {_key(p): (tuple(x.shape), str(x.dtype)) for p, x in
                   jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    got_shapes = {k: (s.shape, str(s.dtype).removeprefix("torch."))
                  for k, s in _pspecs(shapes).items()}
    assert got_shapes == want_shapes
    for group in (None, jsharding.group_axis_for(jmesh)):
        want = _jspecs(jsharding.param_pspecs(jshapes, jcfg, jmesh,
                                              group_axis=group))
        got = _pspecs(sharding.param_pspecs(shapes, cfg, pmesh,
                                            group_axis=group))
        assert got == want, (arch, mesh, group)
    assert sharding.group_axis_for(pmesh) == \
        jsharding.group_axis_for(jmesh)
    for w in (False, True):
        assert sharding.data_axes_for(pmesh, w) == \
            jsharding.data_axes_for(jmesh, w)


DECODE_ARCHS = [a for a in ARCHS
                if configs.get_config(a).supports_decode()]


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_state_pspecs_match_jax(arch, mesh):
    jmesh, pmesh = _meshes(mesh)
    shp = configs.SHAPES["decode_32k"]
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    jstates = jax.eval_shape(lambda: JLM(jcfg).init_states(
        None, shp.global_batch, shp.seq_len))
    states = dryrun.state_specs(LM(cfg), shp.global_batch, shp.seq_len)
    want_shapes = {_key(p): (tuple(x.shape), str(x.dtype)) for p, x in
                   jax.tree_util.tree_flatten_with_path(jstates)[0]}
    got_shapes = {k: (s.shape, str(s.dtype).removeprefix("torch."))
                  for k, s in _pspecs(states).items()}
    assert got_shapes == want_shapes
    want = _jspecs(jstate_pspecs(jstates, jcfg, jmesh))
    assert _pspecs(dryrun._state_pspecs(states, cfg, pmesh)) == want


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_pspec_matches_jax(mesh):
    jmesh, pmesh = _meshes(mesh)
    for stacked in (False, True):
        for extra in (0, 1, 2):
            assert sharding.batch_pspec(pmesh, stacked, extra) == tuple(
                jsharding.batch_pspec(jmesh, stacked, extra))


@pytest.mark.parametrize("spec,shape", [
    (("data", "model"), (32, 48)), (("data", "model"), (8, 48)),
    ((("pod", "data"), None, "model"), (64, 3, 20)),
    ((("pod", "data"), None, "model"), (16, 3, 32)),
    ((None, None), (5, 7)), (("model",), (17,))])
def test_fix_divisibility_matches_jax(spec, shape):
    jmesh, pmesh = _meshes("2x16x16")
    assert sharding._fix_divisibility(spec, shape, pmesh) == tuple(
        jsharding._fix_divisibility(spec, shape, jmesh))


def test_shapes_match_jax():
    assert list(configs.SHAPES) == list(jconfigs.SHAPES)
    for name, s in configs.SHAPES.items():
        j = jconfigs.SHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == \
            (j.name, j.seq_len, j.global_batch, j.kind)


def _spec_dict(tree) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_match_jax(arch):
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    for fn in ("train_batch_specs", "prefill_batch_specs"):
        got = getattr(configs, fn)(cfg, 8, 4096)
        want = getattr(jconfigs, fn)(jcfg, 8, 4096)
        assert _spec_dict(got) == _spec_dict(want), fn
    assert _spec_dict(configs.decode_token_specs(8)) == _spec_dict(
        jconfigs.decode_token_specs(8))


def test_shape_supported_matches_jax():
    pairs = [(a, s) for a in ARCHS for s in configs.SHAPES]
    assert len(pairs) == 40
    got = [configs.shape_supported(a, s) for a, s in pairs]
    assert got == [jconfigs.shape_supported(a, s) for a, s in pairs]
    assert sum(got) == 33       # 10 train, 10 prefill, 9 decode, 4 long


def test_placements_and_local_blocks():
    """A rank's block of a whole tensor under a spec: a dim split over
    several axes is split over their product, the first the slowest."""
    _, pmesh = _meshes("2x16x16")
    x = torch.arange(64 * 3 * 32).reshape(64, 3, 32)
    spec = (("pod", "data"), None, "model")
    assert sharding.local_shape(x.shape, spec, pmesh) == (2, 3, 2)
    got = sharding.local_shard(x, spec, pmesh,
                               {"pod": 1, "data": 3, "model": 5})
    assert torch.equal(got, x[(16 + 3) * 2:(16 + 3) * 2 + 2, :, 10:12])
