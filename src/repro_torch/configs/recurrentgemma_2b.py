"""recurrentgemma-2b — 26L d2560 10H(kv1 MQA) ff7680 v256000, RG-LRU +
local attention (window 2048), pattern (rec, rec, attn).  O(1) state +
bounded window.  [arXiv:2402.19427; hf]"""
from repro_torch.configs import reduce_config
from repro_torch.models.common import ModelConfig
from repro_torch.train import TrainConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab_size=256000, head_dim=256, attn_window=2048, d_rnn=2560,
    conv_width=4, subquadratic=True, block_pattern=("rec", "rec", "attn"),
)

REDUCED = reduce_config(CONFIG)

TRAIN = TrainConfig(microbatches=8, remat="full")
