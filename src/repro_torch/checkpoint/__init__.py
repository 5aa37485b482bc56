from . import manager

__all__ = ["manager"]
