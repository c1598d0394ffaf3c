"""Fast .npz writer (the port's copy of
``paig_reproduction_tpu/utils/npz.py``).

``np.savez_compressed`` deflates at zlib's level 6; level 1 writes the same
npz container (np.load reads it, with the same member names) several times
faster, which matters for the ~74 MB input dump of every eval.
"""
import zipfile

import numpy as np


def savez_fast(path, **arrays):
    """Write a standard .npz (ZIP of .npy members, deflate level 1)."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED,
                         compresslevel=1) as z:
        for name, arr in arrays.items():
            with z.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(arr),
                                          allow_pickle=False)
