from .synthetic import SyntheticImageData, SyntheticSeq2Seq, host_transfer_log

__all__ = ["SyntheticImageData", "SyntheticSeq2Seq", "host_transfer_log"]
