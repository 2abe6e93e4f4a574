"""The benchmark's plain reference: float32 PyTorch, no kernels, no cache,
no batching tricks, and nothing imported from the program."""
