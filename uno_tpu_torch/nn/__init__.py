from uno_tpu_torch.nn.layers import Dense, OperatorBlock, PointwiseOp, SpectralConv, gelu

__all__ = ["Dense", "OperatorBlock", "PointwiseOp", "SpectralConv", "gelu"]
