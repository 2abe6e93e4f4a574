"""chameleon-34b — 48L d8192 64H(kv8) ff22016 v65536, qk-norm, early-fusion
VQ image tokens.  The modality front end is a stub: the model reads
precomputed patch-token embeddings ``(B, S, D)`` (``input_specs`` builds
their stand-ins).  [arXiv:2405.09818; unverified]"""
from repro_torch.configs import reduce_config
from repro_torch.models.common import ModelConfig
from repro_torch.train import TrainConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab_size=65536, qk_norm=True, input_mode="embeddings",
)

REDUCED = reduce_config(CONFIG)

TRAIN = TrainConfig(microbatches=16, remat="full", accum_dtype="bfloat16")
