"""llama4-maverick-400b-a17b — 48L d5120 40H(kv8) ff8192 v202048, MoE 128e
top-1, early fusion.  [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
The reference puts 128 experts in every layer, which gives 778 B
parameters rather than the name's 400 B; the port keeps it verbatim.  128
experts divide a 16-way model axis (expert parallelism)."""
from repro_torch.configs import reduce_config
from repro_torch.models.common import ModelConfig
from repro_torch.train import TrainConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab_size=202048, n_experts=128, top_k=1,
    optimizer="adafactor", opt_state_dtype="bfloat16", param_dtype="bfloat16",
)

REDUCED = reduce_config(CONFIG)

TRAIN = TrainConfig(microbatches=8, remat="full", accum_dtype="bfloat16")
