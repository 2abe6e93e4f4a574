"""RMSNorm's launch plan on the CPU (``ops.rmsnorm_plan``, which picks the
kernel of ``csrc/rmsnorm.cu`` and its launch from the row count), and the
wrapper on the inputs that only the scalar kernel takes, against the JAX
reference.

The plans are pinned for an H100's 132 SMs at every shape the serve paths
launch, and every plan over a grid of shapes is held to what the C entry
point accepts.  The CUDA kernels themselves run only on the card
(``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref
from repro_torch.kernels import build
from repro_torch.kernels.rmsnorm import ops as rn_ops
from repro_torch.kernels.rmsnorm.ops import Plan, rmsnorm_plan

H100_SMS = 132
BF16, F32 = 2, 4


@pytest.mark.parametrize("shape,plan", [
    # Qwen3-8B prefill rows: 256 threads x 2 vectors, two rows a CTA (512
    # CTAs, all resident at once); decode rows: one vector a thread
    ((1024, 4096), Plan("block", 256, 2, 2)),
    ((8, 4096), Plan("block", 512, 1, 1)),
    # RecurrentGemma-2B: 320 vectors a row
    ((1024, 2560), Plan("block", 160, 2, 2)),
    ((8, 2560), Plan("block", 320, 1, 1)),
    # qk-norm rows: 16 lanes a row, two rows a warp
    ((8, 128, 32, 128), Plan("lanes", 256, 1, 16)),
    ((8, 128, 8, 128), Plan("lanes", 256, 1, 16)),
    ((8, 1, 32, 128), Plan("lanes", 32, 1, 2)),
    ((8, 1, 8, 128), Plan("lanes", 32, 1, 2)),
])
def test_main_path_plans(shape, plan):
    rows = int(np.prod(shape[:-1]))
    assert rmsnorm_plan(rows, shape[-1], BF16, True, H100_SMS) == plan


@pytest.mark.parametrize("rows,d,itemsize,aligned", [
    (8, 4096, BF16, False),      # x one element into its storage
    (1024, 128, BF16, False),
    (8, 100, BF16, True),        # 200-byte rows
    (1024, 4095, BF16, True),
    (8, 4095, F32, True),
    (8, 3, F32, True),
    (8, 65536, BF16, True),      # wider than 4 vectors x 512 threads
])
def test_scalar_path(rows, d, itemsize, aligned):
    plan = rmsnorm_plan(rows, d, itemsize, aligned, H100_SMS)
    assert plan.variant == "scalar" and plan.vpt == 1
    assert plan.rows_per_cta == 1
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024


def _accepted(plan: Plan, rows: int, d: int, itemsize: int) -> bool:
    """What ``csrc/rmsnorm.cu``'s ``select`` and ``launch`` accept."""
    nvec, rem = divmod(d * itemsize, 16)
    if plan.threads % 32 or not 32 <= plan.threads <= 1024:
        return False
    if plan.variant == "scalar":
        return plan.rows_per_cta == 1
    if rem:
        return False
    if plan.variant == "lanes":
        lanes = 1 << (nvec - 1).bit_length()
        return (nvec <= 32 and plan.vpt == 1
                and plan.threads <= rn_ops.LANES_CTA
                and plan.rows_per_cta == plan.threads // lanes)
    return (plan.variant == "block" and nvec > 32
            and plan.vpt in rn_ops.MAX_THREADS
            and plan.threads <= rn_ops.MAX_THREADS[plan.vpt]
            and plan.threads * plan.vpt >= nvec and plan.rows_per_cta >= 1)


@pytest.mark.parametrize("itemsize", [BF16, F32])
@pytest.mark.parametrize("d", [8, 64, 100, 128, 256, 384, 1000, 2048, 2560,
                               4096, 5120, 8192, 16384])
@pytest.mark.parametrize("rows", [1, 8, 64, 256, 1024, 32768, 1 << 20])
def test_every_plan_is_launchable(rows, d, itemsize):
    plan = rmsnorm_plan(rows, d, itemsize, True, H100_SMS)
    assert _accepted(plan, rows, d, itemsize), plan
    nvec = d * itemsize // 16
    if plan.variant == "block" and plan.rows_per_cta == 1:
        # every CTA's threads resident at once
        assert rows * plan.threads <= H100_SMS * rn_ops.THREADS_PER_SM
    if plan.variant == "block" and d in (2560, 4096):
        # the compiled widths split into whole warps exactly
        assert plan.threads * plan.vpt == nvec


@pytest.mark.parametrize("rows", [8, 1024, 32768])
def test_grid_stays_resident(rows):
    """Past what fits on the card at once, a CTA takes several rows in
    turn: the grid stays within the resident budget."""
    plan = rmsnorm_plan(rows, 4096, BF16, True, H100_SMS)
    grid = -(-rows // plan.rows_per_cta)
    assert grid * plan.threads <= H100_SMS * rn_ops.THREADS_PER_SM
    assert grid * plan.rows_per_cta >= rows


def test_plan_for_reads_alignment(monkeypatch):
    """A contiguous view with a storage offset passes the wrapper's checks;
    its pointer is not 16-byte aligned, so it takes the scalar kernel."""
    monkeypatch.setattr(build, "sm_count", lambda index: H100_SMS)
    store = torch.zeros(1 + 8 * 4096, dtype=torch.bfloat16)
    w = torch.ones(4096, dtype=torch.bfloat16)
    assert rn_ops.plan_for(store[:-1].view(8, 4096), w) == Plan(
        "block", 512, 1, 1)
    view = store[1:].view(8, 4096)
    assert view.is_contiguous() and view.data_ptr() % 16 == 2
    assert rn_ops.plan_for(view, w).variant == "scalar"


def test_plans_follow_the_sm_count():
    """The lanes CTA shrinks with fewer rows an SM; the block kernel gives a
    thread two vectors, and a CTA more rows, when fewer threads fit."""
    assert rmsnorm_plan(256, 128, BF16, True, 132).threads == 32
    assert rmsnorm_plan(256, 128, BF16, True, 2).threads == 256
    assert rmsnorm_plan(1024, 4096, BF16, True, 264) == Plan(
        "block", 256, 2, 1)
    assert rmsnorm_plan(8, 4096, F32, True, 132) == Plan("block", 1024, 1, 1)
    assert rmsnorm_plan(8, 4096, F32, True, 2) == Plan("block", 512, 2, 2)


@pytest.mark.parametrize("shape,offset", [
    ((8, 4096), 1),
    ((3, 100), 0),
    ((16, 4095), 0),
    ((2, 5, 96), 3),
])
def test_scalar_inputs_match_reference(shape, offset):
    """Inputs that take the scalar kernel on the card: on the CPU the
    wrapper's plain version, against the JAX reference (bf16 x, fp32 w
    rounded to bf16 by both)."""
    rng = np.random.default_rng(sum(shape) + offset)
    n = int(np.prod(shape))
    a = rng.standard_normal(offset + n).astype(np.float32)
    wa = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    store = torch.from_numpy(a).to(torch.bfloat16)
    x = store[offset:].view(shape)
    out = rn_ops.rmsnorm(x, torch.from_numpy(wa))
    ref = jax_rmsnorm_ref(jnp.asarray(a[offset:]).astype(jnp.bfloat16)
                          .reshape(shape), jnp.asarray(wa))
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    err = float(np.max(np.abs(np.asarray(ref.astype(jnp.float32))
                              - out.float().numpy())))
    assert err < 4e-6 * max(1.0, float(jnp.max(jnp.abs(
        ref.astype(jnp.float32)))))
