from .synthetic import (SyntheticImageData, SyntheticLMData, SyntheticSeq2Seq,
                        host_transfer_log)

__all__ = ["SyntheticImageData", "SyntheticLMData", "SyntheticSeq2Seq",
           "host_transfer_log"]
