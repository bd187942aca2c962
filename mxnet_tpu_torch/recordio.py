"""RecordIO: the durable dataset format (reference: python/mxnet/recordio.py
— MXRecordIO/MXIndexedRecordIO over the C API's MXRecordIO* functions, with
dmlc-core's recordio framing underneath).

Counterpart of ``mxnet_tpu/recordio.py``. The byte-level framing runs in
the port's native library (``native/recordio.cc``, built with ``g++`` at
first use) when the toolchain is available, with a pure-Python fallback
producing identical bytes. ``pack``/``unpack`` use the reference's exact
IRHeader struct layout ('IfQQ' + inline float32 label array), so a
``.rec`` / ``.idx`` pair written by either package reads in the other.
Records are host bytes: nothing here touches torch.
"""
import numbers
import os
import struct
from collections import namedtuple

import numpy as np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "MXRecordIOPrefetcher",
           "IRHeader", "pack", "unpack", "pack_img", "unpack_img"]

_MAGIC = 0xced7230a
_LEN_MASK = (1 << 29) - 1


def _native():
    from . import native

    return native.recordio_lib()


class MXRecordIO(object):
    """Sequential .rec reader/writer (reference: recordio.py:36 MXRecordIO).

    Parameters
    ----------
    uri : str
        Path to the .rec file.
    flag : str
        'r' for reading or 'w' for writing.
    """

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self._lib = _native()
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            mode = b"wb"
        elif self.flag == "r":
            mode = b"rb"
        else:
            raise MXNetError("Invalid flag %s" % self.flag)
        if self._lib is not None:
            self.handle = self._lib.rio_open(self.uri.encode(), mode)
            if not self.handle:
                raise MXNetError("cannot open %s" % self.uri)
        else:
            self.handle = open(self.uri, mode.decode())
        self.is_open = True
        self.writable = self.flag == "w"

    def close(self):
        if not self.is_open:
            return
        if self._lib is not None:
            if self.writable:
                self._lib.rio_flush(self.handle)
            self._lib.rio_close(self.handle)
        else:
            self.handle.close()
        self.is_open = False

    def __del__(self):
        self.close()

    def __getstate__(self):
        is_open = self.is_open
        self.close()
        d = dict(self.__dict__)
        d["is_open"] = is_open
        d.pop("handle", None)
        d.pop("_lib", None)
        return d

    def __setstate__(self, d):
        is_open = d.pop("is_open")
        self.__dict__.update(d)
        self._lib = _native()
        self.is_open = False
        self.handle = None
        if is_open:
            self.open()

    def reset(self):
        """Reset the read pointer to the beginning (reference: reset)."""
        self.close()
        self.open()

    def tell(self):
        if self._lib is not None:
            return int(self._lib.rio_tell(self.handle))
        return self.handle.tell()

    def seek(self, pos):
        assert not self.writable
        if self._lib is not None:
            if self._lib.rio_seek(self.handle, pos) != 0:
                raise MXNetError("seek failed")
        else:
            self.handle.seek(pos)

    def write(self, buf):
        """Append one record."""
        assert self.writable
        if not isinstance(buf, (bytes, bytearray)):
            buf = buf.encode()
        if self._lib is not None:
            n = self._lib.rio_write(self.handle, bytes(buf), len(buf), 0)
            if n < 0:
                raise MXNetError("write failed")
            return
        # pure-python framing (identical bytes; dmlc cflag split encoding)
        data = bytes(buf)
        remaining, off, piece = len(data), 0, 0
        while True:
            this_len = min(remaining, _LEN_MASK)
            last = remaining <= _LEN_MASK
            cflag = (0 if last else 1) if piece == 0 else (3 if last else 2)
            self.handle.write(struct.pack("<II", _MAGIC,
                                          (cflag << 29) | this_len))
            self.handle.write(data[off:off + this_len])
            pad = (-this_len) % 4
            if pad:
                self.handle.write(b"\x00" * pad)
            remaining -= this_len
            off += this_len
            piece += 1
            if last:
                break

    def read(self):
        """Read one record; returns bytes or None at EOF."""
        assert not self.writable
        if self._lib is not None:
            import ctypes

            size = self._lib.rio_read(self.handle, None, 0)
            if size < 0:
                return None
            buf = ctypes.create_string_buffer(size)
            got = self._lib.rio_read(self.handle, buf, size)
            if got != size:
                return None
            return buf.raw[:size]
        out = b""
        expect_more, first = True, True
        while expect_more:
            head = self.handle.read(8)
            if len(head) == 0 and first:
                return None  # clean EOF at a record boundary
            if len(head) < 8:
                raise MXNetError("truncated RecordIO header in %s"
                                 % self.uri)
            magic, lrec = struct.unpack("<II", head)
            if magic != _MAGIC:
                raise MXNetError("bad RecordIO magic 0x%x in %s"
                                 % (magic, self.uri))
            cflag, length = lrec >> 29, lrec & _LEN_MASK
            expect_more = (cflag == 1) if first else (cflag == 2)
            first = False
            payload = self.handle.read(length)
            if len(payload) != length:
                raise MXNetError("truncated RecordIO payload in %s"
                                 % self.uri)
            out += payload
            pad = (-length) % 4
            if pad:
                self.handle.read(pad)
        return out


class MXRecordIOPrefetcher(object):
    """Read-only sequential .rec reader with a native read-ahead thread.

    The dmlc::ThreadedIter / PrefetcherIter analog (reference:
    src/io/iter_prefetcher.h:47): a C++ producer thread
    (native/prefetch.cc) keeps a bounded ring of reassembled
    records filled while Python decodes the previous ones, so disk reads
    run off the GIL and overlap with augmentation. Same ``read()`` /
    ``reset()`` surface as ``MXRecordIO`` opened for reading; raises
    MXNetError at construction when the native toolchain is missing
    (callers fall back to MXRecordIO).
    """

    def __init__(self, uri, capacity=8):
        from . import native

        self.uri = uri
        self.capacity = capacity
        self._lib = native.prefetch_lib()
        if self._lib is None:
            raise MXNetError("native prefetcher unavailable "
                             "(no C++ toolchain)")
        self.handle = self._lib.rpf_open(uri.encode(), capacity)
        if not self.handle:
            raise MXNetError("cannot open %s" % uri)

    # picklable like MXRecordIO (workers receive iterators by pickle);
    # the clone restarts from the beginning of the file
    def __getstate__(self):
        return {"uri": self.uri, "capacity": self.capacity}

    def __setstate__(self, d):
        self.__init__(d["uri"], d["capacity"])

    def read(self):
        """Next record's payload bytes; None at EOF."""
        import ctypes

        size = self._lib.rpf_peek_size(self.handle)
        if size == -1:
            return None
        if size == -3:
            raise MXNetError("corrupt RecordIO framing in %s" % self.uri)
        buf = ctypes.create_string_buffer(max(int(size), 1))
        got = self._lib.rpf_next(self.handle, buf, size)
        if got != size:
            raise MXNetError("prefetch read error in %s" % self.uri)
        return buf.raw[:int(size)]

    def reset(self):
        self._lib.rpf_reset(self.handle)

    def close(self):
        if getattr(self, "handle", None):
            self._lib.rpf_close(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class MXIndexedRecordIO(MXRecordIO):
    """Random-access .rec via a companion .idx of ``key\\tbyte-offset``
    lines (reference: recordio.py:170)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if self.writable:
            self.fidx = open(self.idx_path, "w")
        elif os.path.exists(self.idx_path):
            self.fidx = None
            with open(self.idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    if len(parts) != 2:
                        continue
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)

    def close(self):
        if not self.is_open:
            return
        super().close()
        if self.fidx is not None:
            self.fidx.close()
            self.fidx = None

    def __getstate__(self):
        d = super().__getstate__()
        d.pop("fidx", None)
        return d

    def seek(self, idx):
        super().seek(self.idx[idx])

    def read_idx(self, idx):
        """Read the record with the given key."""
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        """Append a record and index it under ``idx``."""
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(key), pos))
        self.idx[key] = pos
        self.keys.append(key)


# --- image-record packing (reference: recordio.py:291-466) -----------------

IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])

_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack a header + raw bytes into an image-record payload; an array
    label is stored inline as float32s with flag = its size."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        header = header._replace(flag=0)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0)
        s = label.tobytes() + s
    return struct.pack(_IR_FORMAT, *header) + s


def unpack(s):
    """Inverse of :func:`pack`; returns (IRHeader, content-bytes)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        header = header._replace(
            label=np.frombuffer(s, np.float32, header.flag).copy())
        s = s[header.flag * 4:]
    return header, s


def unpack_img(s, iscolor=-1):
    """Unpack to (IRHeader, HWC uint8 image) — decodes JPEG/PNG payloads
    (reference uses cv2.imdecode; PIL here)."""
    import io as _io

    from PIL import Image

    header, s = unpack(s)
    img = Image.open(_io.BytesIO(s))
    if iscolor == 0:
        img = img.convert("L")
    elif iscolor == 1 or (iscolor == -1 and img.mode != "L"):
        img = img.convert("RGB")
    return header, np.asarray(img)


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode an HWC uint8 image and pack it (reference: pack_img)."""
    import io as _io

    from PIL import Image

    im = Image.fromarray(np.asarray(img, dtype=np.uint8))
    buf = _io.BytesIO()
    fmt = img_fmt.lower().lstrip(".")
    if fmt in ("jpg", "jpeg"):
        im.save(buf, format="JPEG", quality=quality)
    elif fmt == "png":
        im.save(buf, format="PNG")
    else:
        raise MXNetError("unsupported img_fmt %s" % img_fmt)
    return pack(header, buf.getvalue())
