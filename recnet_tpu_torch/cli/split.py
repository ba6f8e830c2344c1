"""CLI: python -m recnet_tpu_torch.cli.split [--data_root D] [--corpus C]
[--encoder E] (reference: python -m scripts.split).

Splits the corpus's HDF5 features and caption file into train, val and
test files (``data/split.py``). A host tool: numpy, h5py and pandas, no
device.
"""

from recnet_tpu_torch.data.split import main

if __name__ == "__main__":
    main()
