"""The port's span recorder (``repro_torch.spans``) on the CPU: off it
records nothing and costs one flag check; on, a tiny ``generate`` and a
tiny train step record the spans of their layers, with the right parents,
shared identifiers and counts, and the same tokens and losses bit for
bit."""
from __future__ import annotations

import sys
import threading
import time
from collections import Counter

import pytest
import torch

from repro_torch import spans
from repro_torch.models import build_model
from repro_torch.models.common import ModelConfig
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.parallel import Sharder
from repro_torch.serve import generate
from repro_torch.train import TrainConfig, make_train_step

L, P, O = 2, 8, 4             # layers, prompt length, tokens generated
A = 2                         # microbatches


@pytest.fixture(autouse=True)
def recorder():
    """Each test starts and ends with recording off and nothing held."""
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


def _cfg(family: str) -> ModelConfig:
    moe = dict(n_experts=4, top_k=2) if family == "moe" else {}
    return ModelConfig(name=f"spans-{family}", family=family, n_layers=L,
                       d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                       vocab_size=97, compute_dtype="float32", **moe)


def _generate(record: bool):
    model = build_model(_cfg("moe"))
    params = model.init(0, device="cpu")
    prompts = torch.randint(0, 97, (3, P),
                            generator=torch.Generator().manual_seed(1))
    if record:
        spans.enable()
    out = generate(model, params, prompts, Sharder(), steps=O,
                   max_len=P + O)
    spans.disable()
    return out, spans.drain()


def _train(record: bool, family: str = "dense"):
    """Two steps of a tiny model, remat ``full``: the losses, the
    parameters after, and the spans."""
    model = build_model(_cfg(family))
    params = model.init(0, device="cpu")
    ocfg = OptConfig(peak_lr=1e-2, warmup_steps=2, decay_steps=10)
    state = {"params": params, "opt": init_opt_state(params, ocfg),
             "step": torch.zeros((), dtype=torch.int32)}
    step = make_train_step(model, ocfg, TrainConfig(microbatches=A,
                                                    remat="full"), Sharder())
    gen = torch.Generator().manual_seed(2)
    losses = []
    if record:
        spans.enable()
    for _ in range(2):
        t = torch.randint(0, 97, (4, 17), generator=gen)
        state, m = step(state, {"tokens": t[:, :-1], "labels": t[:, 1:]})
        losses.append(m["loss"])
    spans.disable()
    return losses, state["params"], spans.drain()


def _ancestors(rec: list, s) -> list:
    by_id = {r.id: r for r in rec}
    out = []
    while s.parent is not None:
        s = by_id[s.parent]
        out.append(s)
    return out


def _under(rec: list, s, name: str) -> bool:
    return any(a.name == name for a in _ancestors(rec, s))


# ---------------------------------------------------------------------------
# off
# ---------------------------------------------------------------------------
def test_off_span_is_the_shared_noop_and_reads_no_clock(monkeypatch):
    def clock():
        raise AssertionError("a disabled span read the clock")
    monkeypatch.setattr(spans.time, "time_ns", clock)
    first = spans.span("attention")
    assert spans.span("moe", layer=3) is first
    with first:
        with spans.span("layer", layer=0):
            pass
    assert spans.drain() == []


@pytest.mark.parametrize("run", [_generate, _train],
                         ids=["generate", "train_step"])
def test_off_records_nothing(run):
    assert run(False)[-1] == []


# ---------------------------------------------------------------------------
# on: names, counts, parents, identifiers
# ---------------------------------------------------------------------------
def test_generate_records_its_spans():
    """One prefill and ``O - 1`` decode steps of an ``L``-layer MoE model:
    ``L`` layer, attention and MoE spans in each, one sample a token."""
    _, rec = _generate(True)
    n = Counter(s.name for s in rec)
    steps = O                              # the prefill and O - 1 decodes
    assert n == {"serve.generate": 1, "serve.prefill": 1,
                 "serve.decode_step": O - 1, "serve.sample": O,
                 "layer": L * steps, "attention": L * steps,
                 "moe": L * steps, "moe.dispatch": L * steps,
                 "moe.experts": 2 * L * steps}
    for top in (s for s in rec
                if s.name in ("serve.prefill", "serve.decode_step")):
        below = Counter(s.name for s in rec if top in _ancestors(rec, s))
        assert below["moe"] == below["attention"] == L
        assert below["serve.sample"] == 1


def test_generate_parents_and_identifiers():
    _, rec = _generate(True)
    by_name = {}
    for s in rec:
        by_name.setdefault(s.name, []).append(s)
    gen, = by_name["serve.generate"]
    assert gen.parent is None and set(gen.ids) == {"call"}
    for s in rec:
        assert s.ids["call"] == gen.ids["call"]
        assert gen.start_ns <= s.start_ns <= s.end_ns <= gen.end_ns
        assert s.tid == gen.tid == threading.get_native_id()
    assert sorted(s.ids["step"] for s in by_name["serve.decode_step"]) == \
        list(range(O - 1))
    parents = {s.id: s.name for s in rec}
    assert {parents[s.parent] for s in by_name["serve.sample"]} == \
        {"serve.prefill", "serve.decode_step"}
    for name in ("attention", "moe"):
        assert {parents[s.parent] for s in by_name[name]} == {"layer"}
        assert sorted(s.ids["layer"] for s in by_name[name]) == \
            sorted(list(range(L)) * O)
    for name in ("moe.dispatch", "moe.experts"):
        assert {parents[s.parent] for s in by_name[name]} == {"moe"}
    # a later call has another identifier
    _, again = _generate(True)
    assert {s.ids["call"] for s in again} == {gen.ids["call"] + 1}


def test_train_step_records_its_spans_under_remat_full():
    """Attention in the forward, in the recompute and in the backward of
    every layer of every microbatch."""
    _, _, rec = _train(True)
    n = Counter(s.name for s in rec)
    assert n == {"train.step": 2, "train.leaves": 2,
                 "train.microbatch": 2 * A, "train.forward": 2 * A,
                 "train.backward": 2 * A, "train.optimizer": 2,
                 "layer": 2 * A * L, "attention": 2 * A * L * 3}
    att = [s for s in rec if s.name == "attention"]
    fwd = [s for s in att if _under(rec, s, "train.forward")]
    bwd = [s for s in att if _under(rec, s, "train.backward")]
    assert len(fwd) == 2 * A * L and len(bwd) == 2 * 2 * A * L
    assert all(_under(rec, s, "layer") for s in fwd)
    for s in rec:
        if s.name != "train.step":
            step = next(a for a in _ancestors(rec, s)
                        if a.name == "train.step")
            assert s.ids["step"] == step.ids["step"]
    assert sorted(s.ids["step"] for s in rec if s.name == "train.step") \
        == [0, 1]
    for s in att:
        assert s.ids["microbatch"] in range(A)
    for name in ("train.leaves", "train.microbatch", "train.optimizer"):
        assert {_ancestors(rec, s)[0].name for s in rec
                if s.name == name} == {"train.step"}


def test_second_thread_takes_the_main_threads_innermost_span():
    """A span opened on a thread with none open has the main thread's
    innermost open span as parent, and its identifiers; spans nest on
    that thread as on the main one."""
    spans.enable()
    seen = {}

    def work():
        with spans.span("attention", layer=1) as a:
            with spans.span("inner") as b:
                seen["a"], seen["b"] = a, b

    with spans.span("train.step", step=7) as outer:
        with spans.span("train.backward") as waiting:
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    a, b = seen["a"], seen["b"]
    assert a.parent == waiting.id and b.parent == a.id
    assert a.ids == b.ids == {"step": 7, "layer": 1}
    assert a.tid == b.tid != outer.tid == threading.get_native_id()
    assert a.ident == t.ident
    assert [s.name for s in spans.drain()] == [
        "inner", "attention", "train.backward", "train.step"]


def test_threads_record_every_span_once():
    """More recording threads than cores, the switch interval shortened:
    every span is handed over once, with an identifier of its own."""
    n, each = 16, 300
    spans.enable()

    def work():
        for i in range(each):
            with spans.span("outer", i=i):
                with spans.span("inner"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n)]
        for t in threads:
            t.start()
        got = []
        while any(t.is_alive() for t in threads):
            got += spans.drain()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    got += spans.drain()
    assert len(got) == 2 * n * each
    assert len({s.id for s in got}) == len(got)
    outer = {s.id: s for s in got if s.name == "outer"}
    for s in got:
        if s.name == "inner":
            assert outer[s.parent].tid == s.tid


def test_times_are_unix_nanoseconds_and_drain_forgets():
    spans.enable()
    before = time.time_ns()
    with spans.span("serve.generate", call=0):
        pass
    after = time.time_ns()
    s, = spans.drain()
    assert before <= s.start_ns <= s.end_ns <= after
    assert spans.drain() == []


# ---------------------------------------------------------------------------
# results unchanged
# ---------------------------------------------------------------------------
def test_spans_do_not_change_generated_tokens():
    assert torch.equal(_generate(False)[0], _generate(True)[0])


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_spans_do_not_change_train_losses_or_parameters(family):
    off, on = _train(False, family), _train(True, family)
    assert [float(x) for x in off[0]] == [float(x) for x in on[0]]
    from repro_torch.models.common import tree_leaves
    for a, b in zip(tree_leaves(off[1]), tree_leaves(on[1])):
        assert torch.equal(a, b)
