from .celldata import CellData
from .synth import synthetic_dataset

__all__ = ["CellData", "synthetic_dataset"]
