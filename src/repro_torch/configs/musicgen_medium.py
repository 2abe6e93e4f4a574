"""musicgen-medium — 48L d1536 24H(kv24 = MHA) ff6144 v2048, decoder-only
over EnCodec tokens.  The front end is a stub: the model reads precomputed
frame embeddings ``(B, S, D)``.  24 heads divide no 16-way model axis, so
the attention takes the context-parallel branch where its scores are small
(``models.attention.use_context_parallel``).  [arXiv:2306.05284; hf]"""
from repro_torch.configs import reduce_config
from repro_torch.models.common import ModelConfig
from repro_torch.train import TrainConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_ff=6144,
    vocab_size=2048, input_mode="embeddings",
)

REDUCED = reduce_config(CONFIG)

TRAIN = TrainConfig(microbatches=8, remat="full")
