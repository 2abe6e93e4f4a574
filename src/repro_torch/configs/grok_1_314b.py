"""grok-1-314b — 64L d6144 48H(kv8) ff32768 v131072, MoE 8e top-2.
[hf:xai-org/grok-1; unverified]  Eight experts do not divide a 16-way
model axis: the Sharder falls back to the experts' hidden dim there
(TP-experts)."""
from repro_torch.configs import reduce_config
from repro_torch.models.common import ModelConfig
from repro_torch.train import TrainConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=32768,
    vocab_size=131072, n_experts=8, top_k=2,
    optimizer="adafactor", opt_state_dtype="bfloat16", param_dtype="bfloat16",
)

REDUCED = reduce_config(CONFIG)

# 314B on 256 chips: adafactor + bf16 moments + bf16 grad comms to fit HBM
TRAIN = TrainConfig(microbatches=8, remat="full", accum_dtype="bfloat16")
