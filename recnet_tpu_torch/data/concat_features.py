"""Concatenate per-frame feature HDF5s (e.g. 2D InceptionV4 + 3D C3D):
a copy of ``recnet_tpu/data/concat_features.py``.

The RecNet paper's best numbers use concatenated 2D+3D features
(reference README.md:71: "Ours" lags the paper because only 2D features were
used). This tool aligns two feature files by video id, resamples the shorter
stream to the longer one's frame count (uniform linspace, matching
dataset/transform.py:18 semantics), and writes the concatenated features.

CLI: python -m recnet_tpu_torch.data.concat_features a.hdf5 b.hdf5 out.hdf5
"""

from __future__ import annotations

import sys

import numpy as np


def _resample(frames: np.ndarray, n: int) -> np.ndarray:
    if len(frames) == n:
        return frames
    idx = np.linspace(0, len(frames) - 1, n).astype(np.int64)
    return frames[idx]


def concat_features(fpath_a: str, fpath_b: str, out_fpath: str) -> int:
    """Returns the number of videos written (intersection of ids)."""
    import h5py

    with h5py.File(fpath_a, "r") as fa, h5py.File(fpath_b, "r") as fb, \
            h5py.File(out_fpath, "w") as fout:
        common = [vid for vid in fa if vid in fb]
        for vid in common:
            a = np.asarray(fa[vid])
            b = np.asarray(fb[vid])
            n = max(len(a), len(b))
            fout[vid] = np.concatenate(
                [_resample(a, n), _resample(b, n)], axis=1)
    return len(common)


def main():
    if len(sys.argv) != 4:
        print(__doc__)
        sys.exit(1)
    n = concat_features(sys.argv[1], sys.argv[2], sys.argv[3])
    print(f"Wrote {n} videos to {sys.argv[3]}")


if __name__ == "__main__":
    main()
