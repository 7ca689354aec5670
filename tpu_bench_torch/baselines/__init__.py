"""The library tier: benchmark columns that are plain torch.einsum / matmul."""
