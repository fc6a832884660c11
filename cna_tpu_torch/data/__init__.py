from .celldata import CellData
from .synth import synthetic_dataset
from .io_h5ad import read_h5ad, write_h5ad

__all__ = ["CellData", "synthetic_dataset", "read_h5ad", "write_h5ad"]
