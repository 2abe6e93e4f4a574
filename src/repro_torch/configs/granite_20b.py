"""granite-20b — 52L d6144 48H(kv1 = MQA) ff24576 v49152, code model.
[arXiv:2405.04324; hf]"""
from repro_torch.configs import reduce_config
from repro_torch.models.common import ModelConfig
from repro_torch.train import TrainConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
    vocab_size=49152,
)

REDUCED = reduce_config(CONFIG)

TRAIN = TrainConfig(microbatches=16, remat="full")
