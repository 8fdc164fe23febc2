"""A level's initial-weight draw as independent segments of its generator
stream, drawn on host threads with the serial draw's values.

``FLModelFamily.init(generator, level)`` draws a level from one CPU
``torch.Generator`` seeded ``seed + level``: torch's CPU ``randn`` is one
serial MT19937 loop under the generator's lock.  Two facts make the stream
divisible without changing a value:

* a contiguous fp32 ``randn`` of n >= 16 elements consumes exactly n 32-bit
  words, plus 16 more when n % 16 != 0 (torch's ``normal_fill`` turns blocks
  of 16 uniforms into normals and redraws the last 16 values), so a piece
  that starts at a 16-aligned element of a draw and is drawn from a
  generator standing at that element's word equals that part of the serial
  draw bit for bit; a piece that ends its draw keeps the draw's n % 16 and
  so redraws the same tail;
* MT19937 is linear over GF(2), so the state k words on is p(F) applied to
  the seeded state, with p = x^k mod phi (phi its characteristic
  polynomial): a jump that generates none of the words in between
  (Haramoto et al., "Efficient Jump Ahead for F2-Linear Random Number
  Generators", 2008).

``plan_draws`` records a level's draws by running ``init`` once on meta
tensors; ``DrawPlan.segments`` cuts its stream into up to ``workers``
segments of at least ``MIN_PIECE`` elements and caches their jump
polynomials (shapes only); ``InitDraws`` draws each segment into its slice of
one flat buffer on a pool thread, then runs ``init`` again with each draw
returning its slice, so the scale multiplies and stacks run on identical
data.  A level whose plan holds a draw the rule cannot place (under 16
elements, not fp32, not a ``randn``), or that is smaller than two minimum
pieces, is one segment: the serial ``init`` on one pool thread.
"""
from __future__ import annotations

import bisect
import functools
import struct
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

# The least elements of a segment: a thread handoff is noise beside it.
MIN_PIECE = 1 << 22

# MT19937 (torch's CPU generator, ``at::mt19937``)
_N, _M, _DEG = 624, 397, 19937
_UPPER, _LOWER, _MATRIX_A = 0x80000000, 0x7FFFFFFF, 0x9908B0DF
# the CPU generator's state bytes (``CPUGeneratorImplState``): int64 seed,
# int32 left, int32 seeded, uint64 next, uint64 state[624], the double
# path's cached normal (``normal_is_valid`` at byte 5040) and the float
# path's (valid flag at byte 5052)
_LEFT, _NEXT, _TABLE = 8, 16, 24
_DOUBLE_NORMAL_VALID, _FLOAT_NORMAL_VALID = 5040, 5052


def workers() -> int:
    """The draw pool's size: torch's intra-op thread count."""
    return torch.get_num_threads()


# --------------------------------------------------------------- MT19937
def _raw(table: np.ndarray, total: int) -> np.ndarray:
    """The raw (untempered) words x_0 .. x_{total-1} that follow a 624-word
    table x_0 .. x_623, by the recurrence x_{i+624} = x_{i+397} ^
    twist(x_i, x_{i+1}), 227 words at a time."""
    x = np.empty(total, np.uint32)
    x[:_N] = table
    n = _N
    while n < total:
        c, k = n - _N, min(_N - _M, total - n)
        lo, hi = x[c:c + k], x[c + 1:c + k + 1]
        y = (lo & _UPPER) | (hi & _LOWER)
        x[n:n + k] = (x[c + _M:c + _M + k] ^ (y >> 1)
                      ^ np.where(hi & 1, np.uint32(_MATRIX_A), np.uint32(0)))
        n += k
    return x


def _table(state: bytes) -> np.ndarray:
    return np.frombuffer(state, "<u8", _N, _TABLE).astype(np.uint32)


@functools.cache
def _char_poly() -> tuple[int, tuple[int, ...]]:
    """phi, MT19937's characteristic polynomial (bit i the coefficient of
    x^i), by Berlekamp-Massey on one bit of its words; and the table that
    reduces 8 bits at a time: entry t is the multiple of phi whose
    coefficients of x^19937 .. x^19944 are t.  A constant of the
    generator, computed once in the process (about 0.1 s)."""
    seeded = torch.Generator().manual_seed(1).get_state().numpy().tobytes()
    bits = (_raw(_table(seeded), 2 * _DEG + 2)[1:] & 1).tolist()
    conn, prev, length, gap, window = 1, 1, 0, 1, 0
    for n, s in enumerate(bits):
        window = (window << 1) | s
        if not (conn & window).bit_count() & 1:
            gap += 1
        elif 2 * length <= n:
            conn, prev = conn ^ (prev << gap), conn
            length, gap = n + 1 - length, 1
        else:
            conn ^= prev << gap
            gap += 1
    if length != _DEG:
        raise RuntimeError(f"MT19937 recurrence of order {length}")
    # the connection polynomial's reverse
    phi = int(format(conn, f"0{_DEG + 1}b")[::-1], 2)
    table = [0] * 256
    for m in range(256):
        prod = 0
        for i in range(8):
            if m >> i & 1:
                prod ^= phi << i
        table[prod >> _DEG] = prod
    return phi, tuple(table)


def _reduce(a: int, table) -> int:
    while a.bit_length() > _DEG:
        shift = max(0, a.bit_length() - _DEG - 8)
        a ^= table[a >> (_DEG + shift)] << shift
    return a


_POLY_BYTES = _DEG // 8 + 1


def _square(a: int) -> int:
    """a(x)^2 over GF(2): each bit moves to twice its place."""
    bits = np.unpackbits(np.frombuffer(a.to_bytes(_POLY_BYTES, "little"),
                                       np.uint8), bitorder="little")
    spread = np.zeros(2 * bits.size, np.uint8)
    spread[::2] = bits
    return int.from_bytes(np.packbits(spread, bitorder="little").tobytes(),
                          "little")


def jump_poly(k: int) -> np.ndarray:
    """x^k mod phi as the indices of its nonzero coefficients: the state k
    words on is the XOR of the states i words on over those i."""
    if k < 0:
        raise ValueError(f"jump of {k} words")
    phi, table = _char_poly()
    p = 1
    for bit in bin(k)[2:]:
        p = _reduce(_square(p), table)
        if bit == "1":
            p <<= 1
            if p >> _DEG:
                p ^= phi
    bits = np.unpackbits(np.frombuffer(p.to_bytes(_POLY_BYTES, "little"),
                                       np.uint8), bitorder="little")
    return np.flatnonzero(bits).astype(np.int32)


def jump_state(seeded: torch.Tensor, poly: np.ndarray) -> torch.Tensor:
    """The state bytes of a generator standing ``k`` words after
    ``seeded`` (``Generator.get_state()`` of a freshly seeded generator),
    ``poly`` being ``jump_poly(k)``.

    The state i words on is the window x_i .. x_{i+623} of the raw words
    (of x_i only its top bit counts), so the jumped window is the XOR of
    the windows at ``poly``.  The generator is left with one word to its
    next twist (``left`` 1), which turns the window into the 624 words it
    outputs next."""
    state = bytearray(seeded.numpy().tobytes())
    left, = struct.unpack_from("<i", state, _LEFT)
    if (left != 1 or state[_DOUBLE_NORMAL_VALID]
            or state[_FLOAT_NORMAL_VALID]):
        raise ValueError("jump_state needs a freshly seeded generator")
    windows = np.lib.stride_tricks.sliding_window_view(
        _raw(_table(state), _DEG - 1 + _N), _N)
    acc = np.zeros(_N, np.uint32)
    for c in range(0, poly.size, 1024):
        acc ^= np.bitwise_xor.reduce(windows[poly[c:c + 1024]], axis=0)
    state[_TABLE:_TABLE + 8 * _N] = acc.astype("<u8").tobytes()
    struct.pack_into("<Q", state, _NEXT, _N)
    return torch.frombuffer(state, dtype=torch.uint8).clone()


# ------------------------------------------------------------ draw plans
@dataclass(frozen=True)
class Draw:
    """One ``randn`` of a level's ``init``: its shape, first element in the
    level's flat buffer and first word in the level's stream."""
    shape: tuple[int, ...]
    numel: int
    start: int
    word: int

    @property
    def words(self) -> int:
        return self.numel + (16 if self.numel % 16 else 0)


@dataclass(frozen=True)
class Segment:
    """A contiguous run of a level's stream: its pieces (flat start,
    length) drawn one after another from one generator, jumped to the
    run's first word by ``poly``."""
    poly: np.ndarray
    pieces: tuple[tuple[int, int], ...]


class _Unplaceable(Exception):
    """A draw the segment rule cannot place."""


def _draws_from(args, kwargs) -> bool:
    return any(isinstance(a, torch.Generator)
               for a in (*args, *kwargs.values()))


def _meta_randn(func, args, kwargs) -> torch.Tensor:
    """The tensor a generator draw would return, on the meta device; raises
    ``_Unplaceable`` unless it is a contiguous fp32 ``randn`` of 16 or
    more elements."""
    if func is not torch.randn or "out" in kwargs:
        raise _Unplaceable(getattr(func, "__name__", repr(func)))
    meta = func(*args, **{**kwargs, "generator": None, "device": "meta"})
    if meta.dtype != torch.float32 or meta.numel() < 16:
        raise _Unplaceable(f"{meta.dtype} randn of {meta.numel()}")
    return meta


class _Record(TorchFunctionMode):
    """Records each generator draw of ``init`` and returns meta storage."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not _draws_from(args, kwargs):
            return func(*args, **kwargs)
        meta = _meta_randn(func, args, kwargs)
        self.shapes.append(tuple(meta.shape))
        return meta


class _Replay(TorchFunctionMode):
    """Returns each generator draw of ``init`` from its slice of the
    level's filled buffer."""

    def __init__(self, plan: "DrawPlan", flat: torch.Tensor):
        super().__init__()
        self._draws = iter(plan.draws)
        self._flat = flat

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not _draws_from(args, kwargs):
            return func(*args, **kwargs)
        d = next(self._draws, None)
        shape = tuple(_meta_randn(func, args, kwargs).shape)
        if d is None or shape != d.shape:
            raise RuntimeError("init drew otherwise than its draw plan")
        return self._flat[d.start:d.start + d.numel].view(d.shape)


class DrawPlan:
    """A level's generator draws in order, from ``init`` run on meta
    tensors (no value drawn).  ``placeable`` is false when a draw breaks
    the segment rule; the level is then drawn serially."""

    def __init__(self, shapes, placeable: bool = True):
        draws, start, word = [], 0, 0
        for shape in shapes:
            d = Draw(shape, int(np.prod(shape, dtype=np.int64)), start, word)
            draws.append(d)
            start, word = start + d.numel, word + d.words
        self.draws = tuple(draws)
        self._starts = [d.start for d in draws]
        self.elements = start
        self.placeable = placeable
        self._segments = {}           # (workers, min_piece) -> segments

    def segments(self, workers: int, min_piece: int):
        """The stream cut into up to ``workers`` segments of at least
        ``min_piece`` elements, at draw boundaries or at 16-aligned elements
        with ``min_piece`` or more of the draw on each side; None when the
        level is one segment.  Cached with the jump polynomials."""
        if min_piece < 16 or min_piece % 16:
            raise ValueError(f"min_piece {min_piece}: a multiple of 16")
        key = (workers, min_piece)
        if key not in self._segments:
            self._segments[key] = self._cut(workers, min_piece)
        return self._segments[key]

    def _draw_at(self, at: int) -> Draw:
        return self.draws[bisect.bisect_right(self._starts, at) - 1]

    def _snap(self, at: int, min_piece: int) -> int:
        d = self._draw_at(at)
        e = (at - d.start + 8) // 16 * 16
        if min_piece <= e <= d.numel - min_piece:
            return d.start + e
        return d.start if at - d.start < d.start + d.numel - at else (
            d.start + d.numel)

    def _cut(self, workers: int, min_piece: int):
        n = min(workers, self.elements // min_piece)
        if not self.placeable or n < 2:
            return None
        cuts = [0]
        for i in range(1, n):
            c = self._snap(self.elements * i // n, min_piece)
            if c - cuts[-1] >= min_piece and self.elements - c >= min_piece:
                cuts.append(c)
        if len(cuts) < 2:
            return None
        cuts.append(self.elements)
        segments = []
        for a, b in zip(cuts, cuts[1:]):
            pieces = tuple((max(a, d.start), min(b, d.start + d.numel)
                            - max(a, d.start))
                           for d in self.draws
                           if d.start < b and a < d.start + d.numel)
            first = self._draw_at(a)
            word = first.word + (a - first.start)
            segments.append(Segment(jump_poly(word), pieces))
        return tuple(segments)


def plan_draws(init, level: int) -> DrawPlan:
    """``init(generator, level)``'s draw plan, recorded without drawing."""
    rec = _Record()
    try:
        with rec:
            init(torch.Generator(), level)
    except _Unplaceable:
        return DrawPlan((), placeable=False)
    return DrawPlan(rec.shapes)


def draw_segment(flat: torch.Tensor, seeded: torch.Tensor,
                 seg: Segment) -> None:
    """Fill a segment's slices of ``flat`` with the serial stream's
    values."""
    g = torch.Generator()
    g.set_state(jump_state(seeded, seg.poly))
    for start, length in seg.pieces:
        torch.randn(length, generator=g, out=flat[start:start + length])


# ------------------------------------------------------------- the pool
class LevelDraw:
    """One level's draw: its segments' countdown and the tree's future."""

    def __init__(self, init, level: int, seed: int, plan: DrawPlan,
                 segments):
        self.init, self.level, self.seed, self.plan = init, level, seed, plan
        self.segments = segments
        self.tree = Future()
        self._lock = threading.Lock()
        self._left = self.count
        self._error = None
        if segments:
            self.flat = torch.empty(plan.elements)
            self.seeded = torch.Generator().manual_seed(seed).get_state()

    @property
    def count(self) -> int:
        """The level's segment count (1 when drawn serially)."""
        return len(self.segments) if self.segments else 1

    def tasks(self):
        if not self.segments:
            return [self._serial]
        return [functools.partial(self._segment, s) for s in self.segments]

    def _serial(self):
        try:
            tree = self.init(torch.Generator().manual_seed(self.seed),
                             self.level)
        except Exception as e:           # read by take() on the caller
            self.tree.set_exception(e)
            return
        self.tree.set_result(tree)

    def _segment(self, seg: Segment):
        try:
            draw_segment(self.flat, self.seeded, seg)
        except Exception as e:           # read by take() on the caller
            with self._lock:
                self._error = self._error or e
        finally:
            with self._lock:
                self._left -= 1
                last = self._left == 0
            if last:
                self._finish()

    def _finish(self):
        """The last segment's thread: ``init`` replayed on the filled
        buffer."""
        if self._error is not None:
            self.tree.set_exception(self._error)
            return
        try:
            with _Replay(self.plan, self.flat):
                tree = self.init(torch.Generator(), self.level)
        except Exception as e:           # read by take() on the caller
            self.tree.set_exception(e)
            return
        self.tree.set_result(tree)


class InitDraws:
    """The initial-weight draws of one ``FedRAC.train()`` call (or of one
    ``init_params`` call on its own): each submitted level's segments are
    queued, in the order submitted, on a pool of ``n_workers`` host threads;
    the last segment of a level to finish replays ``init`` into its tree.
    Nothing outlives ``close()``: queued work not taken is cancelled."""

    def __init__(self, n_workers: int):
        self.workers = max(1, n_workers)
        self._pool = ThreadPoolExecutor(self.workers,
                                        thread_name_prefix="init-draw")
        self._levels = {}

    def submit(self, init, level: int, seed: int, plan: DrawPlan) -> None:
        """Queue a level's segments (``init``'s draw at ``seed``)."""
        segments = plan.segments(self.workers, MIN_PIECE)
        job = LevelDraw(init, level, seed, plan, segments)
        self._levels[level] = job
        for task in job.tasks():
            self._pool.submit(task)

    def __contains__(self, level: int) -> bool:
        return level in self._levels

    def take(self, level: int):
        """Wait for a submitted level: (its tree, its segment count)."""
        job = self._levels.pop(level)
        return job.tree.result(), job.count

    def close(self) -> None:
        self._levels.clear()
        self._pool.shutdown(wait=True, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
