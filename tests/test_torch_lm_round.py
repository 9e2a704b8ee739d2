"""The LM round step's per-block recomputation, spans and wire-byte counter,
on the CPU (no JAX).

* ``LLCGStepConfig(remat=True)`` recomputes block by block: the gradients
  equal ``remat=False`` bit for bit (a whole round:
  ``tests/test_torch_llcg_steps.py::test_remat_equals_no_remat``), and the
  backward saves fewer bytes outside the blocks (counted with
  ``torch.autograd.graph.saved_tensors_hooks``);
* the round opens ``round`` and its phases, and every step its spans;
* the round counts 2 · G · the parameters' bytes a round (half under
  ``avg_bf16``), and ``train()`` logs what it counts.
"""
import collections

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config
from repro_torch.distributed import steps
from repro_torch.launch import train as ttrain
from repro_torch.models.transformer.model import LM
from repro_torch.optim import adamw
from repro_torch.utils import logging as tracer
from repro_torch.utils.pytree import flatten_with_paths, tree_leaves, tree_map

G, K, S = 2, 2, 1


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small runs of many small ops: one thread each, so that test workers
    sharing the cores do not oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def clean_tracer():
    tracer.disable()
    tracer.reset()
    yield
    tracer.disable()
    tracer.reset()


def _setting(arch="rwkv6-1.6b", seq=21, seed=3):
    """A smoke model and a round's batches; ``seq`` is not a multiple of
    the scan's chunk."""
    cfg = get_smoke_config(arch)
    lm = LM(cfg)
    params = lm.init(seed, "cpu")
    gen = torch.Generator().manual_seed(seed)
    tok = lambda *shape: torch.randint(0, cfg.vocab_size, shape,
                                       generator=gen)
    local = {"tokens": tok(G, K, 1, seq), "labels": tok(G, K, 1, seq)}
    corr = {"tokens": tok(S, 2, seq), "labels": tok(S, 2, seq)}
    return lm, params, local, corr


def _round(lm, params, local, corr, **kw):
    step = steps.build_llcg_round_step(lm, adamw(1e-2), adamw(5e-3),
                                       steps.LLCGStepConfig(G, K, S, **kw))
    params_G = tree_map(lambda x: x.unsqueeze(0).expand(G, *x.shape)
                        .clone(), params)
    out = step(params_G, adamw(1e-2).init(params_G),
               adamw(5e-3).init(params), local, corr)
    return step, out


def _saved_bytes_and_grads(lm, params, batch, remat):
    total = [0]

    def pack(x):
        total[0] += x.numel() * x.element_size()
        return x
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        loss, grads = steps.value_and_grad(steps._loss_fn(lm, remat), params,
                                           batch)
    return total[0], loss, grads


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "gemma3-1b"])
def test_remat_recomputes_block_by_block_bit_for_bit(arch):
    lm, params, local, _ = _setting(arch)
    batch = {k: v[0, 0] for k, v in local.items()}
    plain_bytes, plain_loss, plain = _saved_bytes_and_grads(lm, params,
                                                            batch, False)
    remat_bytes, remat_loss, remat = _saved_bytes_and_grads(lm, params,
                                                            batch, True)
    assert torch.equal(plain_loss, remat_loss)
    for (k, a), (_, b) in zip(flatten_with_paths(plain),
                              flatten_with_paths(remat)):
        assert torch.equal(a, b), k
    # outside the checkpointed blocks only the embedding, the head and the
    # loss save anything
    assert 0 < remat_bytes < plain_bytes / 2


@pytest.mark.parametrize("avg_bf16", [False, True])
def test_round_counts_its_wire_bytes(avg_bf16):
    lm, params, local, corr = _setting()
    f32_bytes = sum(4 * x.numel() for x in tree_leaves(params))
    assert all(x.dtype == torch.float32 for x in tree_leaves(params))
    per_round = 2 * G * f32_bytes // (2 if avg_bf16 else 1)
    assert steps.wire_bytes_per_round(lm, G, avg_bf16) == per_round
    step, out = _round(lm, params, local, corr, avg_bf16=avg_bf16)
    assert step.wire_bytes == per_round
    step(*out[:3], local, corr)
    assert step.wire_bytes == 2 * per_round and step.rounds == 2


def test_round_opens_its_spans_and_nests_them():
    lm, params, local, corr = _setting()
    tracer.enable()
    _round(lm, params, local, corr, remat=True)
    tracer.disable()
    spans = tracer.spans()
    names = collections.Counter(s.name for s in spans)
    assert names == {"round": 1, "round.local": 1, "round.average": 2,
                     "round.correction": 1, "step.forward": G * K + S,
                     "step.backward": G * K + S,
                     "step.optimizer": G * K + S}
    (root,) = [s for s in spans if s.name == "round"]
    assert root.parent is None and root.round == 1
    for s in spans:
        if s.name.startswith("round."):
            assert s.parent is root
        elif s.name.startswith("step."):
            assert s.parent.name in ("round.local", "round.correction")
            assert s.parent.parent is root
        assert s.round == 1
    local_steps = [s for s in spans if s.name == "step.backward"
                   and s.parent.name == "round.local"]
    assert len(local_steps) == G * K


def test_spans_off_record_nothing():
    lm, params, local, corr = _setting()
    _round(lm, params, local, corr)
    assert tracer.spans() == []


def test_train_logs_the_rounds_counted_bytes(monkeypatch):
    counted = []
    build = steps.build_llcg_round_step

    def spy(*args, **kwargs):
        step = build(*args, **kwargs)
        counted.append(step)
        return step
    monkeypatch.setattr(ttrain, "build_llcg_round_step", spy)
    cfg = ttrain.TrainConfig(arch="rwkv6-1.6b", rounds=2, base_k=1, rho=1.0,
                             batch_per_group=1, seq_len=12, remat=True)
    _, metrics = ttrain.train(cfg, device="cpu")
    per_round = steps.wire_bytes_per_round(
        LM(get_smoke_config("rwkv6-1.6b")), 1)
    assert sum(s.wire_bytes for s in counted) == 2 * per_round
    assert [h["comm_mb"] for h in metrics["history"]] == pytest.approx(
        [per_round / 1e6, 2 * per_round / 1e6], rel=1e-12)
    assert counted[0].rounds == 2
