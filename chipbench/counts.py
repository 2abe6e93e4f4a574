"""Operations, bytes and least times, worked out from a configuration's
shapes (its ``run`` section) and a cell's schedule.

Nothing here reads the program: the counts are the same whatever
implements the work, so a change to the program cannot move them.

* Model FLOPs count the work the model needs, no recompute: two FLOPs a
  multiply-add, a MoE token through its ``top_k`` routed experts only,
  causal attention over the pairs it attends, the logits where they are
  used (every position in training, the last prompt position in a
  prefill, the new token in a decode step).
* Least bytes count each weight a step needs read once (the embedding
  rows it looks up, the experts it routes to), and the KV cache it reads
  and writes.
* A kernel call's least time is the larger of its operations over the
  peak rate of its dtype and its bytes (each input read once, each output
  written once) over the HBM rate: ``chip_smoke.py``'s ``bound_ms`` rule.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense, at its 700 W
limit; :func:`power_limit` reads the card's own limit to print beside them.
"""
from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "tf32": 495e12, "float8": 1979e12}
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def power_limit() -> str:
    """``name, power.limit`` of each card as ``nvidia-smi`` prints them
    (empty where it cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip().replace("\n", "; ")


def least_seconds(nbytes: float, flops: float, dtype: str = "bfloat16"):
    """``(seconds, "bytes" | "operations")``: the larger bound."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def attn_params(run) -> int:
    """One layer's q, k, v and output projections."""
    d, dh = run["d_model"], run["head_dim"]
    return d * (run["n_heads"] + 2 * run["n_kv_heads"]) * dh \
        + run["n_heads"] * dh * d


def ffn_params(run) -> int:
    """One SwiGLU MLP, or one expert: gate, up and down."""
    return 3 * run["d_model"] * run["d_ff"]


def layer_params(run) -> int:
    """Every parameter of one layer: projections, two norms, and the MLP
    or the router and all experts."""
    d = run["d_model"]
    ffn = (run["n_experts"] * ffn_params(run) + d * run["n_experts"]
           if run["n_experts"] else ffn_params(run))
    return attn_params(run) + 2 * d + ffn


def param_count(run) -> int:
    """All parameters: embedding, layers, final norm, and an untied head."""
    d, v = run["d_model"], run["vocab_size"]
    head = 0 if run.get("tie_embeddings") else d * v
    return v * d + run["n_layers"] * layer_params(run) + d + head


def weight_bytes(run, dtype: str) -> int:
    return param_count(run) * DTYPE_BYTES[dtype]


def matmul_params_per_token(run) -> int:
    """Weights a token multiplies through in the layers (routed experts
    only, and the router), without the head."""
    d = run["d_model"]
    ffn = ffn_params(run)
    if run["n_experts"]:
        ffn = run["top_k"] * ffn + d * run["n_experts"]
    return run["n_layers"] * (attn_params(run) + ffn)


def causal_pairs(sq: int, skv: int | None = None, offset: int = 0) -> int:
    """(query, key) pairs a causal attention scores: query ``i`` (at
    position ``offset + i``) attends keys ``0 .. offset + i``."""
    skv = sq + offset if skv is None else skv
    return sum(min(skv, offset + i + 1) for i in range(sq))


# ---------------------------------------------------------------------------
# model FLOPs and least bytes of a step
# ---------------------------------------------------------------------------
def train_step_flops(run, batch: int, seq: int) -> float:
    """Forward and backward (3x the forward) of ``batch`` sequences of
    ``seq`` tokens, no recompute: the layers' and head's matmuls and the
    causal attention."""
    d, v = run["d_model"], run["vocab_size"]
    tokens = batch * seq
    per_token = matmul_params_per_token(run) + d * v
    attn = (run["n_layers"] * batch * 2 * 2 * run["n_heads"]
            * run["head_dim"] * causal_pairs(seq))
    return 3.0 * (2.0 * per_token * tokens + attn)


def prefill_flops(run, batch: int, prompt: int) -> float:
    """A prefill's model FLOPs: the layers over every prompt token, the
    causal attention, and the logits of the last position."""
    d, v = run["d_model"], run["vocab_size"]
    attn = (run["n_layers"] * batch * 2 * 2 * run["n_heads"]
            * run["head_dim"] * causal_pairs(prompt))
    return (2.0 * matmul_params_per_token(run) * batch * prompt + attn
            + 2.0 * d * v * batch)


def decode_flops(run, batch: int, live: int) -> float:
    """One decode step: ``batch`` new tokens, each attending ``live``
    keys (its own included), and their logits."""
    d, v = run["d_model"], run["vocab_size"]
    attn = run["n_layers"] * batch * 2 * 2 * run["n_heads"] \
        * run["head_dim"] * live
    return 2.0 * (matmul_params_per_token(run) + d * v) * batch + attn


def kv_row_bytes(run, cache_dtype: str = "bfloat16") -> int:
    """k and v of one position of one sequence, over all layers."""
    return (2 * run["n_layers"] * run["n_kv_heads"] * run["head_dim"]
            * DTYPE_BYTES[cache_dtype])


def step_weight_bytes(run, dtype: str, tokens: int,
                      routed_experts=None) -> int:
    """Weights a serve step reads: the ``tokens`` embedding rows it looks
    up, every layer's projections, norms and router, the experts it routes
    to (``routed_experts``: one count a layer; None means all), the final
    norm and the head."""
    b = DTYPE_BYTES[dtype]
    d, v, n = run["d_model"], run["vocab_size"], run["n_layers"]
    dense = attn_params(run) + 2 * d
    if run["n_experts"]:
        routed = (list(routed_experts) if routed_experts is not None
                  else [run["n_experts"]] * n)
        experts = sum(routed) * ffn_params(run) + n * d * run["n_experts"]
    else:
        experts = n * ffn_params(run)
    head = 0 if run.get("tie_embeddings") else d * v
    return b * (min(tokens, v) * d + n * dense + experts + d + head)


def prefill_least(run, dtype: str, batch: int, prompt: int,
                  routed_experts=None) -> float:
    """Least seconds of a prefill: its model FLOPs at peak or its weights
    and the cache it writes at the HBM rate, whichever is longer."""
    nbytes = (step_weight_bytes(run, dtype, batch * prompt, routed_experts)
              + batch * prompt * kv_row_bytes(run))
    return least_seconds(nbytes, prefill_flops(run, batch, prompt),
                         dtype)[0]


def decode_least(run, dtype: str, batch: int, live: int,
                 routed_experts=None) -> float:
    """Least seconds of a decode step over ``live`` cached positions (the
    new one included): its weights, the cache it reads and the row it
    writes, or its model FLOPs."""
    nbytes = (step_weight_bytes(run, dtype, batch, routed_experts)
              + batch * live * kv_row_bytes(run))
    return least_seconds(nbytes, decode_flops(run, batch, live), dtype)[0]


# ---------------------------------------------------------------------------
# kernel calls
# ---------------------------------------------------------------------------
def flash_attention_least(b: int, sq: int, skv: int, h: int, kvh: int,
                          dh: int, causal: bool = True,
                          dtype: str = "bfloat16") -> float:
    """q and out (B,Sq,H,dh), k and v (B,Skv,KVH,dh) moved once; the
    scores and the weighted sum of the pairs attended."""
    nbytes = DTYPE_BYTES[dtype] * (2 * b * sq * h * dh + 2 * b * skv * kvh
                                   * dh)
    pairs = causal_pairs(sq, skv, skv - sq) if causal else sq * skv
    return least_seconds(nbytes, 4.0 * b * h * dh * pairs, dtype)[0]


def flash_decode_least(b: int, h: int, kvh: int, dh: int, live: int,
                       dtype: str = "bfloat16") -> float:
    """q and out (B,H,dh), the ``live`` cached k and v rows read once."""
    nbytes = DTYPE_BYTES[dtype] * (2 * b * h * dh + 2 * b * live * kvh * dh)
    return least_seconds(nbytes, 4.0 * b * h * dh * live, dtype)[0]


def rmsnorm_least(rows: int, d: int, dtype: str = "bfloat16") -> float:
    """x read, y written, the weight read."""
    nbytes = DTYPE_BYTES[dtype] * (2 * rows * d + d)
    return least_seconds(nbytes, 4.0 * rows * d, dtype)[0]


KERNEL_LEAST = {"flash_attention": flash_attention_least,
                "flash_decode": flash_decode_least,
                "rmsnorm": rmsnorm_least}


def calls_least(calls) -> dict:
    """``{op: least seconds}`` of kernel calls given as ``(op, kwargs,
    count)``."""
    out: dict = {}
    for op, kw, n in calls:
        out[op] = out.get(op, 0.0) + n * KERNEL_LEAST[op](**kw)
    return out


def calls_count(calls) -> dict:
    out: dict = {}
    for op, _, n in calls:
        out[op] = out.get(op, 0) + n
    return out
