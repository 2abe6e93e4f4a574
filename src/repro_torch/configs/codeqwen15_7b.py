"""codeqwen1.5-7b — 32L d4096 32H(kv32 = MHA) ff13440 v92416.
[hf:Qwen/CodeQwen1.5-7B; hf]"""
from repro_torch.configs import reduce_config
from repro_torch.models.common import ModelConfig
from repro_torch.train import TrainConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=13440,
    vocab_size=92416,
)

REDUCED = reduce_config(CONFIG)

TRAIN = TrainConfig(microbatches=8, remat="full")
