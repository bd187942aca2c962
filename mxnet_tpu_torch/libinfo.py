"""Library metadata (reference: python/mxnet/libinfo.py:64 — locates
libmxnet.so and declares __version__).

Counterpart of ``mxnet_tpu/libinfo.py``. Here the "library" is the set of
shared objects the port builds on demand under ``_build/``: the CUDA
kernels (``cuda_build``) and the native readers (``native``)."""
import os

__version__ = "1.0.0"


def find_lib_path():
    """Paths of the built shared objects (the libmxnet.so analog); empty
    when nothing has been built yet."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "_build")
    found = []
    for dirpath, _dirs, files in os.walk(root):
        found.extend(os.path.join(dirpath, f) for f in files
                     if f.endswith(".so"))
    return sorted(found)
