"""xlstm-1.3b — 48L d2048 4H, sLSTM + mLSTM blocks (1:1 alternating, as
the reference), O(1) recurrent state -> runs long_500k.  The reference's
layout gives 2,623,686,848 parameters, not the name's 1.3 B; ported
verbatim.  [arXiv:2405.04517; unverified]"""
from repro_torch.configs import reduce_config
from repro_torch.models.common import ModelConfig
from repro_torch.train import TrainConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=50304, subquadratic=True, mlstm_chunk=256,
    block_pattern=("mlstm", "slstm"),
)

REDUCED = reduce_config(CONFIG)

TRAIN = TrainConfig(microbatches=8, remat="full")
