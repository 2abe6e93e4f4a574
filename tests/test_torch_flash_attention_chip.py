"""Flash attention's backward kernels on the card, against the plain
backward (``attention_bwd``) in fp32 on the same values: the cases of
``chip_smoke.FLASH_BWD_CASES`` -- head dims 64, 128 and 256 (and 16, 40,
100), groups of 1, 4 and 8 and MQA 48/1 and 10/1, causal and not, windows,
``q_offset`` with Sq < Skv, ragged Sq/Skv, rows that see no key, f16.

    python -m pytest --noconftest -q -m chip tests/test_torch_flash_*chip.py

Every test needs a CUDA device and skips without one (decided in the
``gen`` fixture).  This file imports nothing of JAX and needs no fixture
of ``tests/conftest.py`` (which imports JAX), so with ``--noconftest`` it
runs on the machine with the card.  Tolerance: the forward kernel's 2e-2
of max(1, the largest plain gradient), on bf16/f16 gradients of order 1
(``chip_smoke.FLASH_BWD_TOL``): P and dS are rounded to the input dtype as
operands, and each gradient once on the way out.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()
CASES = cs.FLASH_BWD_CASES


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the backward kernels run on the "
                    "H100")
    return torch.Generator(device="cuda").manual_seed(3)


@pytest.mark.chip
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_backward_matches_plain_version(gen, case):
    """Within the tolerance of the plain backward; a row that sees no key
    gets a zero dq and adds nothing to dk and dv; a repeat equals the first
    call bit for bit (no atomics); one forward launch and one backward
    call."""
    r = cs.flash_bwd_check(case, gen)
    assert r["finite"], r
    assert all(e <= t for e, t in zip(r["errs"], r["tols"])), r
    assert r["unseen_dq_zero"] and r["unseen_rows_add_nothing"], r
    assert r["repeat_equal"], r
    assert r["counts"] == (1, 1), r


@pytest.mark.chip
@pytest.mark.parametrize("hsplit", [2, 5, 10])
def test_head_split_matches_whole_group(gen, hsplit, monkeypatch):
    """CTAs sharing a kv tile's query heads (fp32 partial sums added by
    the sum kernel) give the whole group's dk and dv within one bf16
    rounding of the largest, and the same dq bit for bit (the dQ kernel
    does not share)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    case = ("mqa 10/1 dh256 window100 B2 S256", 2, 256, 256, 10, 1, 256,
            True, 100, 0, "bfloat16")
    q, k, v, do = cs.flash_bwd_inputs(case, gen)
    o, lse = fa_ops._launch_lse(q, k, v, True, 100, 0)
    runs = []
    for split in (1, hsplit):
        monkeypatch.setattr(fa_ops, "bwd_head_split", lambda *a, s=split: s)
        runs.append(fa_ops._launch_bwd(do, q, k, v, o, lse, True, 100, 0))
    whole, shared = runs
    assert torch.equal(whole[0], shared[0])
    for w, s in zip(whole[1:], shared[1:]):
        tol = torch.finfo(torch.bfloat16).eps * w.float().abs().max().item()
        assert (w.float() - s.float()).abs().max().item() <= tol


LSE_CASES = [c for c in CASES if c[0].startswith(("granite", "masked rows",
                                                   "all rows masked"))]


@pytest.mark.chip
@pytest.mark.parametrize("case", LSE_CASES, ids=[c[0] for c in LSE_CASES])
def test_forward_lse_matches_plain(gen, case):
    """The forward's lse against ``attention_lse`` in fp32 on the same
    values (1e-4 of max(1, |lse|): fp32 sums in another order, exp2), -inf
    where a row sees no key; its output equals the serving instance's bit
    for bit."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_lse

    _, _, _, _, _, _, _, causal, window, q_offset, _ = case
    q, k, v, _ = cs.flash_bwd_inputs(case, gen)
    o, lse = fa_ops._launch_lse(q, k, v, causal, window, q_offset)
    want = attention_lse(q.float(), k.float(), causal=causal, window=window,
                         q_offset=q_offset)
    assert torch.equal(torch.isneginf(lse), torch.isneginf(want))
    seen = ~torch.isneginf(want)
    err = (lse[seen] - want[seen]).abs()
    assert bool((err <= 1e-4 * want[seen].abs().clamp_min(1.0)).all())
    assert torch.equal(o, fa_ops._launch(q, k, v, causal, window, q_offset))


@pytest.mark.chip
def test_no_grad_and_fp32_take_no_backward_kernel(gen):
    """Serving (no grad) launches the forward alone; fp32 tensors keep the
    plain backward (a rule by dtype): neither moves ``bwd_launches``."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    case = next(c for c in CASES if c[0].startswith("mha 8/8"))
    q, k, v, do = cs.flash_bwd_inputs(case, gen)
    before = (fa_ops.launches, fa_ops.bwd_launches)
    with torch.no_grad():
        fa_ops.attend(q, k, v, causal=False)
    ts = [t.float().requires_grad_() for t in (q, k, v)]
    fa_ops.attend(*ts, causal=False).backward(do.float())
    torch.cuda.synchronize()
    assert (fa_ops.launches - before[0], fa_ops.bwd_launches - before[1]) \
        == (2, 0)
    assert all(t.grad is not None for t in ts)
