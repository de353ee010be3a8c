from .image import load_gray, load_pgm, save_pgm
from .dataset import (FrameSequence, load_kitti_poses, save_kitti_poses,
                      ate_rmse, stock_pair, synthetic_pair,
                      synthetic_sequence, textured_image)

__all__ = ["load_gray", "load_pgm", "save_pgm", "FrameSequence",
           "load_kitti_poses", "save_kitti_poses", "ate_rmse",
           "stock_pair", "synthetic_pair", "synthetic_sequence",
           "textured_image"]
