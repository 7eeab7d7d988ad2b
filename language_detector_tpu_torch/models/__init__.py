from .ngram import NgramBatchEngine

__all__ = ["NgramBatchEngine"]
