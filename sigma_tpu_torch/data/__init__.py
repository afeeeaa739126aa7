"""Data pipeline of the port: copies of `sigma_tpu/data/` (numpy, the
PNG reader / writer `png.py`, the JPEG decoder `jpeg.py` and the
cv2-exact resize `resize.py`)."""

from sigma_tpu_torch.data.dataset import RGBXDataset
from sigma_tpu_torch.data.loader import TrainLoader
from sigma_tpu_torch.data.transforms import TrainPre, ValPre, normalize

__all__ = ["RGBXDataset", "TrainPre", "ValPre", "normalize", "TrainLoader"]
