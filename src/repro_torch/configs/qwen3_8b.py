"""qwen3-8b — 36L d4096 32H(kv8) ff12288 v151936, qk-norm.
[hf:Qwen/Qwen3-8B; hf]  ``rope_theta`` stays at the reference's 10000
(the published model uses 1e6): the reference is the target."""
from repro_torch.configs import reduce_config
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=12288,
    vocab_size=151936, qk_norm=True, head_dim=128,
)

REDUCED = reduce_config(CONFIG)
