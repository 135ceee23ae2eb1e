from .pipeline import SyntheticTokens, TokenFileDataset

__all__ = ["SyntheticTokens", "TokenFileDataset"]
