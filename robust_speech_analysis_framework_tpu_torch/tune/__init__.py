"""Hyperparameter search: the TPE sampler and its study (numpy)."""

from .tpe import Study, TPESampler, Trial, create_study

__all__ = ["Study", "TPESampler", "Trial", "create_study"]
