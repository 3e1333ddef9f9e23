"""Sliders as data: the values of a stream's params that its captured
block step reads from device memory.

The JAX package's stream step takes the params as an argument of the
compiled program (``jax.jit(cg.fn)(state, ext, params)``,
dsp_stuff_tpu/runtime/stream.py:124, :160): a moved slider runs the same
program on another value.  The port's step is one captured CUDA graph
(runtime/block_graph.py), which reads what it reads by address, so a
moved slider is a copy into device buffers that the graph reads:

* a float slider of the stream's params reaches the nodes as a
  :class:`Data`, a *root* holding the slider's value on the host;
* what a node's float path derives from a value on the host (the
  envelope's ``exp(-1/frames)`` gains, ``1 - r``, the Toeplitz constants
  of a blocked solve, a biquad's coefficients over a0) it derives with
  :func:`lift`: for plain numbers the plain call (the float path,
  unchanged), for a Data another Data, kept in the root's :class:`Scope`
  so that the next step finds the same one;
* where the float path puts a value on the device
  (``precision.on_device``, ``scan._const``) or into an op as a Python
  float (:func:`num`), a Data gives its buffer (:meth:`Data.on`), made at
  first use in the dtype that path uses and held by the capture underway
  (utils/capture.hold);
* where the float path branches on a value (a biquad's degenerate forms,
  the envelope's route), it reads :func:`form`, which records the value.

A move (:meth:`Scope.move`) sets the roots, derives every Data again on
the host and copies the values that changed into their buffers: on the
card from a pinned staging tensor, ordered on the current stream before
the next replay.  It reports whether every recorded form kept its value
(and every value its shape); when one did not, the step binds its params
anew and, on the card, captures again.  So the buffers hold what the float
path feeds its ops, in that path's dtype, and a step over Data is bitwise
the same step over the Python floats.

A Data refuses to be read as a number (``float``, ``bool``, a comparison,
arithmetic): code that would read a slider on the host where it should
take it as data raises instead of baking the value in.
"""

from __future__ import annotations

import numpy as np
import torch

from dsp_stuff_tpu_torch.utils.capture import hold


def _refuse(self, *args):
    raise TypeError("a slider of a stream step is data on the device; "
                    "derive from it with sliders.lift, branch on it with "
                    "sliders.form, take its buffer with sliders.num or "
                    "precision.on_device")


def _frozen(v):
    """A comparable snapshot of a host value, a tuple of values included
    (NaN equal to NaN)."""
    if isinstance(v, (tuple, list)):
        return tuple(_frozen(x) for x in v)
    a = np.asarray(v)
    return a.shape, a.dtype.str, a.tobytes()


def _shape(v):
    if isinstance(v, (tuple, list)):
        return tuple(_shape(x) for x in v)
    return np.shape(v)


class Data:
    """A host value that a stream step reads from device memory: a slider
    (``fn`` None) or ``fn(*args)`` of other values, some of them Data."""

    __slots__ = ("scope", "fn", "args", "value", "bufs")

    def __init__(self, scope: "Scope", fn, args: tuple, value):
        self.scope, self.fn, self.args, self.value = scope, fn, args, value
        # (device, dtype) -> (buffer, its pinned staging on the card)
        self.bufs: dict = {}

    __float__ = __int__ = __index__ = __bool__ = _refuse
    __eq__ = __ne__ = __lt__ = __le__ = __gt__ = __ge__ = _refuse
    __add__ = __radd__ = __sub__ = __rsub__ = _refuse
    __mul__ = __rmul__ = __truediv__ = __rtruediv__ = __neg__ = _refuse
    __hash__ = object.__hash__

    @property
    def shape(self) -> tuple:
        """The value's shape: structural (a move that changes it binds the
        params anew), so code may read it."""
        return _shape(self.value)

    def on(self, device, dtype: torch.dtype | None = None) -> torch.Tensor:
        """The buffer of this value on ``device`` in ``dtype`` (the value's
        own NumPy dtype when None): made at first use (on the card with
        the pinned staging a move copies it from), refilled at every move,
        held by the capture underway."""
        key = (torch.device(device), dtype)
        got = self.bufs.get(key)
        if got is None:
            src = torch.from_numpy(_host(self.value, dtype))
            got = self.bufs[key] = (src.to(key[0]), src.pin_memory()
                                    if key[0].type == "cuda" else None)
        return hold(got[0])


def _np_of(dtype: torch.dtype | None):
    return None if dtype is None else torch.empty((), dtype=dtype).numpy(
    ).dtype


def _host(value, dtype: torch.dtype | None) -> np.ndarray:
    """``value`` as a contiguous NumPy array in ``dtype``'s NumPy type,
    rounded once (to nearest, as ``torch.tensor(value, dtype=...)``)."""
    return np.array(value, dtype=_np_of(dtype), copy=True, ndmin=0)


class Scope:
    """The Data of one binding of a stream's params: the roots by path,
    what ops derived from them (in the order made, so each comes after
    what it reads), the forms read, and the staging of their copies."""

    def __init__(self):
        self.roots: dict = {}
        self.derived: dict = {}         # memo key -> Data
        self.forms: dict = {}           # id -> (Data, frozen value)
        self._done = None               # event after the last copies

    def root(self, path, value: float) -> Data:
        d = self.roots[path] = Data(self, None, (), value)
        return d

    def move(self, values: dict) -> bool:
        """Set each root at ``values`` (path -> float), derive every Data
        again and copy each changed value into its buffers.  Returns
        False, copying nothing, when a form or a shape moved: the caller
        binds anew."""
        new = {}
        for path, d in self.roots.items():
            new[id(d)] = values[path]
        for d in self.derived.values():
            new[id(d)] = d.fn(*(new[id(a)] if isinstance(a, Data) else a
                                for a in d.args))
        for d, frozen in self.forms.values():
            if _frozen(new[id(d)]) != frozen:
                return False
        moved = []
        for d in (*self.roots.values(), *self.derived.values()):
            v = new[id(d)]
            if _shape(v) != d.shape:
                return False
            if _frozen(v) != _frozen(d.value):
                moved.append((d, v))
        if moved and self._done is not None:
            self._done.synchronize()    # the staging is free again
        for d, v in moved:
            d.value = v
            for (_, dtype), (b, stage) in d.bufs.items():
                src = torch.from_numpy(_host(v, dtype))
                if stage is not None:
                    stage.copy_(src)
                    b.copy_(stage, non_blocking=True)
                else:
                    b.copy_(src)
        cards = {dev for d, _ in moved for dev, _ in d.bufs if dev.type
                 == "cuda"}
        if cards:
            if self._done is None:
                self._done = torch.cuda.Event()
            self._done.record(torch.cuda.current_stream(next(iter(cards))))
        return True


def _key_of(a):
    """``a`` in a memo key: a Data by identity, an array by content."""
    if isinstance(a, Data):
        return "d", id(a)
    if isinstance(a, np.ndarray):
        return "a", a.shape, a.dtype.str, a.tobytes()
    if isinstance(a, (tuple, list)):
        return "t", tuple(_key_of(x) for x in a)
    return "v", a


def lift(fn, *args):
    """``fn(*args)`` on the host.  With no Data among ``args`` this is the
    plain call: the float path.  Otherwise the Data of that value, made
    once per scope (memoised by ``fn``'s code and the arguments; ``fn``
    may close over nothing, since a closure would hide what it reads)."""
    data = [a for a in args if isinstance(a, Data)]
    if not data:
        return fn(*args)
    if getattr(fn, "__closure__", None):
        raise TypeError(f"sliders.lift: {fn!r} closes over values; pass "
                        f"them as arguments")
    scope = data[0].scope
    key = (getattr(fn, "__code__", fn), tuple(_key_of(a) for a in args))
    d = scope.derived.get(key)
    if d is None:
        d = scope.derived[key] = Data(scope, fn, args, fn(*(
            a.value if isinstance(a, Data) else a for a in args)))
    return d


def _item(v, i):
    return v[i]


def item(v, i):
    """``v[i]``, of a Data too."""
    return lift(_item, v, i)


def form(v):
    """The host value of ``v``, on which an op branches.  For a Data the
    value is recorded: a move that changes it binds the params anew (on
    the card: captures again)."""
    if isinstance(v, Data):
        v.scope.forms[id(v)] = (v, _frozen(v.value))
        return v.value
    return v


def num(v, like: torch.Tensor):
    """``v`` as an operand of an op on ``like``: a plain number stays a
    Python float (the float path), a Data is its buffer in ``like``'s
    dtype (the same value: PyTorch rounds a Python float to the tensor's
    dtype)."""
    if isinstance(v, Data):
        return v.on(like.device, like.dtype)
    return v
