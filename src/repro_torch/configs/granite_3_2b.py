"""granite-3-2b — 40L d2048 32H(kv8) ff8192 v49155.  The vocab divides no
mesh axis: the Sharder's prefix fallback replicates the embedding and the
head over ``model``.  [hf:ibm-granite/granite-3.0-2b-base; hf]"""
from repro_torch.configs import reduce_config
from repro_torch.models.common import ModelConfig
from repro_torch.train import TrainConfig

CONFIG = ModelConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, d_ff=8192,
    vocab_size=49155,
)

REDUCED = reduce_config(CONFIG)

TRAIN = TrainConfig(microbatches=8, remat="full")
