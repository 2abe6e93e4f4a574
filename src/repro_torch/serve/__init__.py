from .serve import (ServeConfig, generate, make_decode_step,
                    make_prefill_step, sample)

__all__ = ["ServeConfig", "generate", "make_decode_step",
           "make_prefill_step", "sample"]
