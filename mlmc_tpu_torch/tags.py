"""Integer sample identity + lazy tag sequences (counterpart of
``mlmc_tpu/tags.py``).

A sample is identified by the integer pair ``(level_id, index)`` everywhere
inside the package — the DeviceBatchPool's random numbers derive from the
pair directly (a Philox counter) — and the ``"L%02d_S%07d"`` string tags
are materialized lazily, vectorized, only where a caller asks for them.
"""
import itertools
import numpy as np

_PREFIX = "L{:02d}_S"
_WIDTH = 7


def format_tag(level_id: int, index: int) -> str:
    """(2, 123) -> 'L02_S0000123'."""
    return "L{:02d}_S{:07d}".format(level_id, index)


def format_tags(level_id: int, indices) -> np.ndarray:
    """Vectorized tag materialization: digits computed as a uint8 matrix
    (np.char is interpreter-speed; this is pure C array arithmetic)."""
    idx = np.asarray(indices, dtype=np.int64)
    if idx.size and int(idx.max()) >= 10 ** _WIDTH:
        # beyond the fixed %07d field: defer to per-element widening
        return np.array([format_tag(level_id, i) for i in idx.tolist()])
    prefix = _PREFIX.format(level_id).encode("ascii")
    n_pre = len(prefix)
    width = n_pre + _WIDTH
    out = np.empty((idx.shape[0], width), dtype=np.uint8)
    out[:, :n_pre] = np.frombuffer(prefix, dtype=np.uint8)
    rem = idx
    for pos in range(width - 1, n_pre - 1, -1):
        out[:, pos] = 48 + rem % 10
        rem = rem // 10
    return out.view("S%d" % width).ravel().astype("U%d" % width)


def parse_tag(tag) -> tuple:
    """'L02_S0000123' -> (2, 123)."""
    if isinstance(tag, (bytes, np.bytes_)):
        tag = tag.decode()
    level_part, _, sample_part = str(tag).partition("_")
    return int(level_part[1:]), int(sample_part[1:])


def parse_tags(tags) -> np.ndarray:
    """Vectorized sample indices of a tag array -> int64.

    Fast path assumes the uniform fixed-width layout format_tags produces;
    anything else falls back to a per-element parse.
    """
    arr = np.asarray(tags)
    if arr.size == 0:
        return np.zeros(0, np.int64)
    if arr.dtype.kind == "U":
        arr = arr.astype("S%d" % max(arr.dtype.itemsize // 4, 1))
    if arr.dtype.kind == "S":
        w = arr.dtype.itemsize
        b = arr.view(np.uint8).reshape(arr.size, w)
        first = bytes(b[0]).rstrip(b"\0").decode()
        sep = first.find("_S")
        tag_len = len(first)
        if sep > 0:
            lengths = (b != 0).sum(axis=1)
            digits = b[:, sep + 2:tag_len].astype(np.int64) - 48
            if (lengths == tag_len).all() and ((digits >= 0) & (digits <= 9)).all():
                scale = 10 ** np.arange(digits.shape[1] - 1, -1, -1, dtype=np.int64)
                return digits @ scale
    return np.array([parse_tag(t)[1] for t in arr.tolist()], dtype=np.int64)


class TagRange:
    """Lazy, contiguous range of sample tags for one level.

    Behaves as a sequence of strings (len / iter / getitem / np.array), but
    costs O(1) to construct and pass around — the Sampler schedules a level
    by handing a TagRange to the pool and storage instead of building one
    string per sample.
    """

    __slots__ = ("level_id", "start", "stop", "_cache")

    def __init__(self, level_id: int, start: int, stop: int):
        self.level_id = int(level_id)
        self.start = int(start)
        self.stop = int(stop)
        self._cache = None

    @property
    def indices(self) -> np.ndarray:
        return np.arange(self.start, self.stop, dtype=np.int64)

    def materialize(self) -> np.ndarray:
        """Render as an array of ``L{l}_S{n}`` id strings (cached)."""
        if self._cache is None:
            self._cache = format_tags(self.level_id, self.indices)
        return self._cache

    def __len__(self):
        return max(self.stop - self.start, 0)

    def __getitem__(self, i):
        if isinstance(i, slice):
            rng = range(self.start, self.stop)[i]
            if rng.step == 1:
                return TagRange(self.level_id, rng.start, rng.stop)
            # stepped/reversed slices are no longer contiguous: return a
            # lazy TagArray over the exact indices (a TagRange built from
            # start/stop alone silently dropped the step)
            return TagArray(self.level_id, np.fromiter(rng, dtype=np.int64))
        idx = range(self.start, self.stop)[i]
        return format_tag(self.level_id, idx)

    def __iter__(self):
        return iter(self.materialize().tolist())

    def __array__(self, dtype=None, copy=None):
        arr = self.materialize()
        return arr.astype(dtype) if dtype is not None else arr

    def __repr__(self):
        return "TagRange(L{:02d}, {}:{})".format(self.level_id, self.start, self.stop)


class TagArray:
    """Lazy tag sequence over an arbitrary index array of one level.

    The DeviceBatchPool reports finished samples as a TagArray, so a
    million collected ids cost one int array until somebody (e.g. the HDF
    checkpoint writer) actually needs the strings.
    """

    __slots__ = ("level_id", "indices", "_cache")

    def __init__(self, level_id: int, indices):
        self.level_id = int(level_id)
        self.indices = np.asarray(indices, dtype=np.int64)
        self._cache = None

    def materialize(self) -> np.ndarray:
        """Render as an array of ``L{l}_S{n}`` id strings (cached)."""
        if self._cache is None:
            self._cache = format_tags(self.level_id, self.indices)
        return self._cache

    def __len__(self):
        return self.indices.shape[0]

    def __getitem__(self, i):
        if isinstance(i, slice):
            return TagArray(self.level_id, self.indices[i])
        return format_tag(self.level_id, int(self.indices[i]))

    def __iter__(self):
        return iter(self.materialize().tolist())

    def __array__(self, dtype=None, copy=None):
        arr = self.materialize()
        return arr.astype(dtype) if dtype is not None else arr

    def tolist(self):
        """Materialized id strings as a Python list."""
        return self.materialize().tolist()

    def __add__(self, other):
        if isinstance(other, TagArray) and other.level_id == self.level_id:
            return TagArray(self.level_id,
                            np.concatenate([self.indices, other.indices]))
        return list(self) + list(other)

    def __radd__(self, other):
        return list(other) + list(self)


class TagChain:
    """Concatenation of tag sequences with O(1) ``extend``.

    Storage backends keep scheduled-id logs as chains of TagRange /
    list segments, so recording a million scheduled samples is a pointer
    append, not a million-string write.
    """

    __slots__ = ("_segments", "_n")

    def __init__(self, segments=()):
        self._segments = []
        self._n = 0
        for seg in segments:
            self.extend(seg)

    def extend(self, seq):
        """Append a TagRange/TagArray/sequence of ids lazily."""
        if isinstance(seq, (TagRange, TagArray, TagChain, list, tuple,
                            np.ndarray)):
            self._segments.append(seq)
            self._n += len(seq)
        else:  # arbitrary iterable
            seq = list(seq)
            self._segments.append(seq)
            self._n += len(seq)

    def append(self, tag):
        """Add one id (string or (level, index) tag) to the chain."""
        self._segments.append([tag])
        self._n += 1

    def __len__(self):
        return self._n

    def __iter__(self):
        return itertools.chain.from_iterable(self._segments)

    def __getitem__(self, i):
        if i < 0:
            i += self._n
        if i < 0:
            raise IndexError("tag chain index out of range")
        for seg in self._segments:
            if i < len(seg):
                return seg[i]
            i -= len(seg)
        raise IndexError(i)

    def __array__(self, dtype=None, copy=None):
        if not self._segments:
            return np.zeros(0, dtype=dtype or "U16")
        arr = np.concatenate([np.asarray(s) for s in self._segments])
        return arr.astype(dtype) if dtype is not None else arr
