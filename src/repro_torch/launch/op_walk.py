"""Op-level cost walker, the port's twin of ``repro.launch.hlo_walk``.

The reference walks the optimized HLO of a jitted step, scaling each while
body by its trip count. The port has no HLO: ``OpWalk`` is a
``TorchDispatchMode`` that sees every aten op a step runs, eagerly, and
accumulates per device a ``Costs(flops, bytes, coll_bytes,
per_collective)``, the reference's record, with the FLOPs also split by
dtype (``flops_by_dtype``):

  * FLOPs — the matmul family through ``torch.utils.flop_counter``'s
    formulas (2 x result x contraction for ``mm`` / ``bmm`` / ``addmm``,
    the einsums' lowering), keyed by the inputs' dtype; plus, for each
    kernel call on the kernel route (a CUDA tensor with kernels on, or a
    fake CUDA tensor), the call's ``cost`` from its wrapper
    (``kernels.cost``). On the kernel route that record stands for the
    whole call: the aten ops the wrapper itself issues (an aligned copy,
    the empty outputs) are not counted. On the plain route the wrapper
    records nothing and its plain ops are counted as they run, as the
    reference's dry run counts the XLA reference path.
  * bytes — operands plus results of every op that materializes. Views
    and factory ops (``empty``, ``zeros``, ``arange``, ...) cost nothing,
    as ``NO_TRAFFIC`` in ``hlo_walk.py``. Eager torch fuses nothing, so
    this is an upper bound, like the walker's fusion-boundary bytes.
  * collective bytes — the bytes of every copy whose source and
    destination are two different cards, counted at the receiving card and
    labelled by the enclosing ``collective(kind)`` (``collectives.
    all_reduce``: "all-reduce"; ``ring_shift``: "collective-permute";
    ``ShardedTensor.full``: "all-gather"); an unlabelled copy between two
    cards is a point-to-point "collective-permute". A copy between the host
    and a card moves inputs or results, not a step's device work, and
    counts nothing.
  * peak live bytes per device: each storage counted once across its
    views, from when the walk first sees it until its last tensor goes.

A walk has no trip counts of its own: a Python loop runs its body as
often as it runs, and each run is counted. The backward's ops run on
autograd's device thread on the card; the mode is thread-local state that
autograd carries there, so they are counted too. The trip counts come
from ``TripScale``, the twin of ``hlo_walk``'s scaling of a while body by
its trip count: the dry run (``launch.dryrun``) walks each repeated unit
of a cell (the layer stack, the micro-steps, the time loop) at two small
counts and solves each count of the walk for the full ones, exactly.

Placeholder devices (``placeholders``): the twin of the reference's 512
host-platform devices. Inside it every tensor is a ``FakeTensor`` (no
data, nothing allocated), and a tensor placed on ``cuda:k`` — by a
factory's ``device=``, by ``.to`` — carries ``cuda:k`` as its placeholder
device: ``.device`` and ``.is_cuda`` report it, so the port's code places,
moves and routes as on a card, and the walk attributes by it. Underneath,
torch sees the host: a fake tensor's own device is the CPU, so no CUDA
device guard, stream or autograd device thread is ever asked for a card
(none exists here, and ``cuda:255`` exists nowhere). A tensor made without
a device inside a walk (a composite op's workspace made from its input's
options) is placed where the last placed op ran.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from collections import defaultdict
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost as _kcost

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

aten = torch.ops.aten
#: ops that create a tensor without reading one, or only relabel one
#: (``_unsafe_view``: a reshape of a fresh result): no traffic
FACTORIES = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "zeros", "zeros_like", "new_zeros", "ones", "ones_like", "new_ones",
    "full", "full_like", "new_full", "arange", "scalar_tensor", "rand",
    "rand_like", "randn", "randn_like", "randint", "randperm", "eye",
    "linspace", "lift_fresh", "lift_fresh_copy", "_local_scalar_dense",
    "set_", "resize_", "_unsafe_view"})
_COPIES = (aten._to_copy.default, aten.copy_.default)


def _flat(tree, out=None) -> List[torch.Tensor]:
    """The tensors of a call's arguments or results (nested tuples, lists
    and dicts), in ``tree_flatten``'s order; a walk's hot path, where
    ``tree_flatten`` cost a quarter of a walk's time."""
    if out is None:
        out = []
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _flat(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _flat(x, out)
    return out


def nbytes(t: torch.Tensor) -> int:
    """Bytes of a tensor's elements (a view: its own extent)."""
    return t.numel() * t.element_size()


@dataclasses.dataclass
class Costs:
    """One device's counts (``hlo_walk.Costs``' fields; ``flops`` is the
    sum of ``flops_by_dtype``)."""
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    per_collective: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    flops_by_dtype: Dict[str, float] = dataclasses.field(
        default_factory=dict)

    def add_flops(self, key: str, n: float):
        self.flops += n
        self.flops_by_dtype[key] = self.flops_by_dtype.get(key, 0.0) + n

    def add(self, other: "Costs", scale: float = 1.0):
        self.bytes += other.bytes * scale
        self.coll_bytes += other.coll_bytes * scale
        for k, v in other.per_collective.items():
            self.per_collective[k] = self.per_collective.get(k, 0.0) \
                + v * scale
        for k, v in other.flops_by_dtype.items():
            self.add_flops(k, v * scale)

    def as_dict(self) -> Dict:
        return {"flops": self.flops, "flops_by_dtype": dict(
            sorted(self.flops_by_dtype.items())), "bytes": self.bytes,
            "coll_bytes": self.coll_bytes,
            "per_collective": dict(self.per_collective)}


# ---------------------------------------------------------------------------
# trip counts
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Unit:
    """A repeated unit of a step, the twin of a ``lax.scan``: its trip
    count in the full step, and the counts it is walked at, ``lo`` and
    every ``hi - lo`` after it as far as a term's power of it needs."""
    name: str
    full: int
    lo: int
    hi: int


def _choose(z: Fraction, k: int) -> Fraction:
    out = Fraction(1)
    for i in range(k):
        out = out * (z - i) / (i + 1)
    return out


class TripScale:
    """A step's counts at its full trip counts, solved from walks at small
    ones: the twin of ``hlo_walk``'s scaling of each while body by its trip
    count, for a walk that sees no loop. Each count is taken to be a
    polynomial in the units' trip counts with one coefficient a term of
    ``terms``: a tuple of units whose counts multiply, a unit named twice
    for its square (``()``: the work outside every unit; ``("layers",)``:
    a layer's; ``("layers", "accum")``: a layer's in a micro-step;
    ``("seq_len", "seq_len")``: work that grows with the square of the
    length). The terms are closed under dropping a factor. There is one
    walk a term (``points``), each unit at ``lo`` plus its power in the
    term times ``hi - lo``, and the counts at the full trip counts are the
    terms' forward differences times binomials (Newton's form), exact
    (``Fraction``). A count that does not come out a whole number >= 0
    from whole-number walks cannot be fit, and ``fit`` raises, naming the
    units of its terms."""

    def __init__(self, units, terms=None):
        self.units = tuple(units)
        names = [u.name for u in self.units]
        for u in self.units:
            if not 1 <= u.lo < u.hi or u.full < u.lo:
                raise ValueError(f"{u.name}: cannot walk {u.lo} and {u.hi} "
                                 f"to solve for {u.full}")
        if terms is None:
            terms = [()] + [(n,) for n in names]
        self.terms = [tuple(sorted(t)) for t in terms]
        for t in self.terms:
            if not set(t) <= set(names):
                raise ValueError(f"term {t}: units {names}")
            for u in set(t):
                less = list(t)
                less.remove(u)
                if tuple(less) not in self.terms:
                    raise ValueError(f"term {t} without {tuple(less)}")
        self._z = {u.name: Fraction(u.full - u.lo, u.hi - u.lo)
                   for u in self.units}

    def point(self, term) -> Tuple[int, ...]:
        return tuple(u.lo + term.count(u.name) * (u.hi - u.lo)
                     for u in self.units)

    def points(self) -> List[Tuple[int, ...]]:
        """The walks' counts, in the order of ``units``: one a term."""
        return [self.point(t) for t in self.terms]

    def walked(self) -> Dict[str, List[int]]:
        """{unit: the counts it is walked at}."""
        return {u.name: sorted({p[i] for p in self.points()})
                for i, u in enumerate(self.units)}

    def _differences(self, term):
        """[(coefficient, sub-term)] of the term's forward difference."""
        out = [(1, ())]
        for u in sorted(set(term)):
            k = term.count(u)
            out = [(c * (-1) ** (k - j) * math.comb(k, j),
                    tuple(sorted(sub + (u,) * j)))
                   for c, sub in out for j in range(k + 1)]
        return out

    def fit(self, samples: Dict[Tuple[int, ...], Dict]) -> Dict:
        """{key: count at the full trip counts} from {point: {key:
        count}} (a key missing from a walk counts 0 there)."""
        keys = {k: None for s in samples.values() for k in s}
        diffs = {t: self._differences(t) for t in self.terms}
        scale = {}
        for t in self.terms:
            z = Fraction(1)
            for u in set(t):
                z *= _choose(self._z[u], t.count(u))
            scale[t] = z
        out = {}
        for key in keys:
            f = {t: Fraction(samples[self.point(t)].get(key, 0))
                 for t in self.terms}
            total, parts = Fraction(0), []
            for t in self.terms:
                delta = sum(c * f[sub] for c, sub in diffs[t])
                if delta:
                    parts.append(t)
                total += delta * scale[t]
            whole = all(v.denominator == 1 for v in f.values())
            if whole and (total.denominator != 1 or total < 0):
                units = sorted({u for t in parts for u in t})
                raise ValueError(
                    f"{', '.join(units) or 'no unit'}: {key!r} cannot be fit "
                    f"exactly: {float(total)} at "
                    f"{ {u.name: u.full for u in self.units} } from walks "
                    f"{ {self.point(t): int(f[t]) for t in self.terms} }")
            out[key] = int(total) if total.denominator == 1 else \
                float(total)
        return out


# ---------------------------------------------------------------------------
# the collective label
# ---------------------------------------------------------------------------

_KIND = {"kind": None}


@contextlib.contextmanager
def collective(kind: str):
    """Label the copies between cards made inside as one collective of
    ``kind`` (one of ``COLLECTIVES``) for an active walk; with none it
    changes nothing. Inside ``placeholders()`` the copies are placed on
    their cards (``placing``) also where autograd runs them (a backward, a
    remat's recompute)."""
    if kind not in COLLECTIVES:
        raise ValueError(f"collective kind {kind!r}: one of {COLLECTIVES}")
    prev, _KIND["kind"] = _KIND["kind"], kind
    try:
        with placing():
            yield
    finally:
        _KIND["kind"] = prev


# ---------------------------------------------------------------------------
# placeholder devices
# ---------------------------------------------------------------------------

class Card(str):
    """A placeholder card: ``cuda:<index>`` for any index. torch's own
    device index is 8 bits wide (``torch.device("cuda", 255)`` is
    ``cuda``), so a 16 x 16 mesh cannot name its 256 cards with
    ``torch.device``. A ``Card`` is a string whose value is ``"cpu"``,
    which torch's argument parser takes for a device; it prints, compares
    and hashes as ``cuda:<index>``. Inside ``placeholders()`` the function
    mode meets it before torch reads it and places the call's outputs on
    the card, so it goes wherever the port passes a device (``device=``,
    ``.to``), and a placed tensor's ``.device`` is its ``Card``. Where
    torch reads it unseen (code run inside an overridable call: an
    autograd ``Function``, the backward), it reads the host, which is
    what every placeholder is underneath, and the output is placed by its
    inputs."""
    type = "cuda"

    def __new__(cls, index: int):
        card = super().__new__(cls, "cpu")
        card._index = int(index)
        return card

    @property
    def index(self) -> int:
        return self._index

    def __str__(self):
        return f"cuda:{self._index}"

    def __repr__(self):
        return f"Card({self._index})"

    def __format__(self, spec):
        return format(str(self), spec)

    def __eq__(self, other):
        if isinstance(other, Card):
            return other._index == self._index
        if isinstance(other, torch.device):
            return other.type == "cuda" and other.index == self._index
        return False

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return hash(("cuda", self._index))

    def __reduce__(self):
        return (Card, (self._index,))


def cards(n: int):
    """``Card(0) .. Card(n - 1)``."""
    return [Card(i) for i in range(n)]


_ATTR = "_placeholder_device"
#: the active placeholders' mode; ``inside``: depth of the fake mode's own
#: dispatch (where a fake tensor's ``.device`` is its host device);
#: ``target``: the card (or the host) the current call asked for;
#: ``default``: the card of the current call's first placed input, where
#: the ops inside it make tensors without a device
_PLACE = {"mode": None, "inside": 0, "target": None, "default": None}
_HOST = "host"
_FAKE_DEVICE = FakeTensor.device   # the property FakeTensor defines


def _placed_device(self):
    if not _PLACE["inside"]:
        dev = self.__dict__.get(_ATTR)
        if dev is not None:
            return dev
    return _FAKE_DEVICE.fget(self)


def _placed_is_cuda(self):
    return _placed_device(self).type == "cuda"


def placeholder_device(t) -> Optional[Card]:
    """A fake tensor's placeholder card (None: on the host)."""
    return t.__dict__.get(_ATTR) if isinstance(t, FakeTensor) else None


def _as_card(dev):
    """``dev`` (a ``Card``, a ``torch.device``, a string or a CUDA index) as
    a ``Card``; ``_HOST`` for the host; None for no device."""
    if dev is None or isinstance(dev, Card):
        return dev
    if isinstance(dev, int):            # torch's own CUDA index
        return Card(dev)
    dev = torch.device(dev)
    if dev.type != "cuda":
        return _HOST
    return Card(dev.index or 0)


def _to_args(args, kwargs):
    """``Tensor.to``'s (device, dtype, copy) from its call."""
    device = kwargs.get("device")
    dtype = kwargs.get("dtype")
    copy = kwargs.get("copy", False)
    bools = []
    for a in args[1:]:
        if isinstance(a, torch.dtype):
            dtype = a
        elif isinstance(a, torch.Tensor):
            device, dtype = a.device, a.dtype
        elif isinstance(a, bool):
            bools.append(a)
        elif a is not None:
            device = a
    if len(bools) > 1:          # (non_blocking, copy)
        copy = bools[1]
    return device, dtype, copy


class _PlaceFn(TorchFunctionMode):
    """Before torch reads a device, replace a card with the host and hold
    the card as the target the outputs are placed on; a call that names no
    device and takes no tensor makes host tensors; ``Tensor.to`` a
    tensor's own card is the tensor itself, as on a card."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func is torch.device and args and isinstance(args[0], Card):
            return args[0]
        if func is torch.Tensor.to:
            x = args[0]
            device, dtype, copy = _to_args(args, kwargs)
            target = _as_card(device)
            if target is None:
                return func(*args, **kwargs)
            here = placeholder_device(x) or _HOST
            if target == here:
                if (dtype is None or dtype == x.dtype) and not copy:
                    return x
                return self._call(None, func, (x,), {"dtype": dtype or
                                                     x.dtype, "copy": copy})
            return self._call(target, func, (x,), {
                "device": "cpu", "dtype": dtype or x.dtype, "copy": True})
        target = _as_card(kwargs.get("device"))
        if isinstance(target, Card):
            kwargs["device"] = "cpu"
        flat = _flat((args, kwargs))
        if target is None and not flat:
            target = _HOST              # made without a device: the host
        default = next((d for d in map(placeholder_device, flat)
                        if d is not None), None)
        return self._call(target, func, args, kwargs, default)

    @staticmethod
    def _call(target, func, args, kwargs, default=None):
        prev = _PLACE["target"], _PLACE["default"]
        _PLACE["target"], _PLACE["default"] = target, default
        try:
            return func(*args, **kwargs)
        finally:
            _PLACE["target"], _PLACE["default"] = prev


class _Place(TorchDispatchMode):
    """Gives each output its placeholder card: the one the call asked
    for, else its first placed input's, else (a tensor made without a
    device inside a call: a composite op's workspace) the call's first
    placed input's, else the last placed op's (inside an overridable call
    such as ``autograd.grad``, which the function mode does not see
    into). A card asked for at this level is placed the same way."""

    def __init__(self):
        super().__init__()
        self.last: Optional[Card] = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        target = _PLACE["target"]
        asked = _as_card(kwargs.get("device"))
        if isinstance(asked, Card):
            target, kwargs["device"] = asked, torch.device("cpu")
        flat = _flat((args, kwargs))
        _PLACE["inside"] += 1
        try:
            out = func(*args, **kwargs)
        finally:
            _PLACE["inside"] -= 1
        if target is _HOST:
            return out
        dev = target or next((d for d in (placeholder_device(t)
                                          for t in flat) if d is not None),
                             None)
        if dev is None and not flat:
            dev = _PLACE["default"] or self.last
        if dev is not None:
            self.last = dev
            for t in _flat(out):
                if isinstance(t, FakeTensor):
                    t.__dict__[_ATTR] = dev
        return out


@contextlib.contextmanager
def placing():
    """Inside ``placeholders()``, the function mode that places ``.to`` a
    card and the factories: autograd runs a custom ``Function``'s backward
    without the torch function modes of its forward, so a backward that
    moves tensors between cards enters this first. Elsewhere, and where the
    mode is already on, it changes nothing."""
    on = _PLACE["mode"] is not None and not any(
        isinstance(torch._C._get_function_stack_at(i), _PlaceFn)
        for i in range(torch._C._len_torch_function_stack()))
    if not on:
        yield
        return
    with _PlaceFn():
        yield


def _clear_device_caches():
    """The per-device tensors the models cache (head masks, RoPE
    frequencies): a placeholder run must neither read a card's nor leave
    its fakes behind."""
    from repro_torch.models import attention, layers

    for fn in (layers._inv_freq_on, layers._mrope_owner_on,
               attention._head_mask_on, attention._head_to_kv_on,
               attention._index_on):
        fn.cache_clear()


@contextlib.contextmanager
def placeholders():
    """Placeholder devices: inside, tensors are fakes and any ``cuda:k`` (a
    ``Card`` or a ``torch.device``) needs no card (see the module's
    docstring). Build on ``"cpu"`` inside, then place with ``.to`` or
    ``sharding.device_put``; enter ``OpWalk`` inside to count. Nothing is
    allocated."""
    if _PLACE["mode"] is not None:
        raise RuntimeError("placeholders() is already active")
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    place, place_fn = _Place(), _PlaceFn()
    lift = torch._C._only_lift_cpu_tensors()
    own = {k: FakeTensor.__dict__.get(k) for k in ("device", "is_cuda")}
    _clear_device_caches()
    FakeTensor.device = property(_placed_device)
    FakeTensor.is_cuda = property(_placed_is_cuda)
    torch._C._set_only_lift_cpu_tensors(True)
    _PLACE["mode"] = place
    try:
        with fake, place, place_fn:
            yield
    finally:
        _PLACE["mode"] = None
        for k, v in own.items():          # FakeTensor's own, or none
            if v is None:
                delattr(FakeTensor, k)
            else:
                setattr(FakeTensor, k, v)
        torch._C._set_only_lift_cpu_tensors(lift)
        _clear_device_caches()


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------


def device_of(t: torch.Tensor) -> str:
    """The device a tensor's work is counted on: its placeholder device
    inside ``placeholders``, else its own."""
    return str(t.device)


def _is_card(dev: str) -> bool:
    return dev.startswith("cuda")


@dataclasses.dataclass(frozen=True)
class KernelRecord:
    name: str
    device: str
    cost: _kcost.KernelCost

    def key(self) -> Tuple:
        return (self.name, self.device, self.cost.terms, self.cost.bytes)


class OpWalk(TorchDispatchMode):
    """Counts every aten op run inside, per device (see the module's
    docstring). ``costs``: {device: Costs}; ``kernels``: the kernel
    records in call order; ``peak_live``: {device: peak live bytes};
    ``argument_bytes``: {device: bytes of the tensors passed to
    ``track``}."""

    def __init__(self):
        super().__init__()
        self.costs: Dict[str, Costs] = defaultdict(Costs)
        self.kernels: List[KernelRecord] = []
        self.live: Dict[str, int] = defaultdict(int)
        self.peak_live: Dict[str, int] = defaultdict(int)
        self.argument_bytes: Dict[str, int] = defaultdict(int)
        #: {device: {op name: [calls, flops, bytes]}}: each device's
        #: share of ``costs`` by op (a call counted where its outputs are),
        #: kernel records under their wrapper's name
        self.by_device_op: Dict[str, Dict[str, List[float]]] = defaultdict(
            lambda: defaultdict(lambda: [0, 0.0, 0.0]))
        self._storages: Dict[int, Tuple[str, int]] = {}
        self._quiet = 0
        self._open = False
        self._prev = None

    # -- entering ---------------------------------------------------------

    def __enter__(self):
        self._prev = _kcost.ACTIVE["walk"]
        _kcost.ACTIVE["walk"] = self
        self._open = True
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._open = False
            _kcost.ACTIVE["walk"] = self._prev

    # -- what the program reports ----------------------------------------

    def kernel(self, name: str, like: torch.Tensor,
               cost: _kcost.KernelCost, launch):
        """Record one kernel call's ``cost`` on ``like``'s device, then run
        ``launch`` (the wrapper's kernel route) with its ops uncounted."""
        dev = device_of(like)
        self.kernels.append(KernelRecord(name, dev, cost))
        c = self.costs[dev]
        for n, key in cost.terms:
            c.add_flops(key, n)
        c.bytes += cost.bytes
        row = self.by_device_op[dev][name]
        row[0] += 1
        row[1] += cost.operations
        row[2] += cost.bytes
        self._quiet += 1
        try:
            out = launch()
        finally:
            self._quiet -= 1
        for t in _flat(out):
            self._see(t)
        return out

    def track(self, *trees):
        """Count the tensors of ``trees`` (parameters, optimizer state,
        inputs; ``ShardedTensor`` leaves by their shards) as the step's
        arguments, live from the start."""
        for tree in trees:
            for t in _tensors(tree):
                if self._see(t):
                    self.argument_bytes[device_of(t)] += \
                        t.untyped_storage().nbytes()

    # -- results ------------------------------------------------------------

    def total(self) -> Costs:
        out = Costs()
        for c in self.costs.values():
            out.add(c)
        return out

    def kernel_keys(self) -> List[Tuple]:
        return [r.key() for r in self.kernels]

    @property
    def by_op(self) -> Dict[str, List[float]]:
        """{op name: [calls, flops, bytes]} over every device."""
        out: Dict[str, List[float]] = {}
        for ops in self.by_device_op.values():
            for name, row in ops.items():
                acc = out.setdefault(name, [0, 0.0, 0.0])
                for i, v in enumerate(row):
                    acc[i] += v
        return out

    # -- the dispatch -------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._quiet:
            for t in _flat(out):
                self._see(t)
            return out
        ins = _flat((args, kwargs))
        outs = _flat(out)
        for t in ins + outs:
            self._see(t)
        name = func.overloadpacket.__name__
        if func in _COPIES:
            src = args[1] if func is aten.copy_.default else args[0]
            dst = args[0] if func is aten.copy_.default else out
            s_dev, d_dev = device_of(src), device_of(dst)
            if s_dev != d_dev:
                if _is_card(s_dev) and _is_card(d_dev):
                    b = nbytes(dst)
                    c = self.costs[d_dev]
                    c.coll_bytes += b
                    kind = _KIND["kind"] or "collective-permute"
                    c.per_collective[kind] += b
                    self.costs[s_dev].bytes += nbytes(src)
                    c.bytes += b
                    label = f"{name} ({kind})"
                    self.by_device_op[d_dev][label][0] += 1
                    self.by_device_op[d_dev][label][2] += b
                    self.by_device_op[s_dev][label][2] += nbytes(src)
                return out
        if func.is_view or name in FACTORIES or not ins or not outs:
            return out
        dev = device_of(outs[0]) if outs else device_of(ins[0])
        c = self.costs[dev]
        mine = self.by_device_op[dev][name]
        mine[0] += 1
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            n = formula(*args, **kwargs, out_val=out)
            c.add_flops(_kcost.dtype_key(ins[0].dtype), n)
            mine[1] += n
        for t in ins:
            d = device_of(t)
            self.costs[d].bytes += nbytes(t)
            self.by_device_op[d][name][2] += nbytes(t)
        out_bytes = sum(nbytes(t) for t in outs)
        c.bytes += out_bytes
        mine[2] += out_bytes
        return out

    def _see(self, t: torch.Tensor) -> bool:
        """Start counting ``t``'s storage as live (once); True if new."""
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return False
        key = st._cdata
        if key in self._storages:
            return False
        dev, n = device_of(t), st.nbytes()
        self._storages[key] = (dev, n)
        self.live[dev] += n
        if self.live[dev] > self.peak_live[dev]:
            self.peak_live[dev] = self.live[dev]
        weakref.finalize(st, self._free, key)
        return True

    def _free(self, key: int):
        if not self._open:
            return
        dev, n = self._storages.pop(key, (None, 0))
        if dev is not None:
            self.live[dev] -= n


def _tensors(tree):
    """The tensors of a nested dict / list / tuple; a ``ShardedTensor``
    gives its shards."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    shards = getattr(tree, "shards", None)
    return list(shards) if shards is not None else []
