from .results import Result

__all__ = ["Result"]
