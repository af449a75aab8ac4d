"""The port does all that the JAX package does: every public function and
class defined in a module of ``versalignlib_tpu`` has a counterpart of the
same name in the port's module of the same dotted path, with the same
parameter names in the same order, except for the departures by design in
:data:`DEPARTURES`. Each departure must still match a real difference, so
the table cannot grow stale. The checker is a plain function, held on two
fake modules too. Only imports and ``inspect``."""

import importlib
import inspect
import pkgutil
import types
from typing import NamedTuple

import versalignlib_tpu
import versalignlib_tpu_torch


class Departure(NamedTuple):
    """One difference by design. ``kind``: ``module`` (no counterpart),
    ``name`` (not ported), ``moved`` (the port has it in module ``new``),
    ``renamed`` (parameter ``old`` becomes one of ``new``), ``dropped``
    (parameter ``old`` is gone), ``added`` (parameter ``new`` is the port's
    own), ``fields`` (another set of dataclass fields). ``where``: a module
    or ``module.name``, a tuple of them, or ``*`` for every function."""

    kind: str
    where: str | tuple
    old: str | None = None
    new: str | tuple | None = None


_MESH_SCORES = ("parallel.distributed.distributed_score_batch",
                "parallel.multihost.multihost_score_batch")
_MESH_ALIGNS = ("parallel.distributed.distributed_align_batch",
                "parallel.multihost.multihost_align_batch")

#: The departures by design, each from ROADMAP §C ("Departures by design")
#: or its "Not ported" list.
DEPARTURES = [
    Departure("module", "ops.pallas_align"),    # Not ported: Pallas; B2, B3 are csrc/align*.cu
    Departure("module", "ops.pallas_backend"),  # Not ported: the `pallas` backend name (§C)
    Departure("module", "ops.pallas_score"),    # Not ported: Pallas; B1 is csrc/score.cu
    Departure("module", "ops.pallas_search"),   # Not ported: Pallas; B4 is csrc/search.cu
    Departure("module", "ops.xla"),             # §C: the `xla` backend name; ops/plain.py
    Departure("name", "ops.pssm.make_pssm_sub_fn"),  # Not ported: a jnp closure for Pallas
    Departure("moved", "ops.pssm.pssm_scores_device", new="ops.cuda_search"),  # §C
    Departure("renamed", "*", "interpret", ("device",)),  # §C: interpret= becomes device=
    Departure("renamed", "*", "impl", ("device",)),       # §C: impl= becomes device=
    Departure("renamed", "*", "backend", ("device",)),    # §C: backend= becomes device=
    Departure("renamed", "*", "sharding", ("device", "mesh")),  # §C: prefetch_to_device
    Departure("renamed", "*", "chunk_blocks", ("chunk_pairs",)),  # §C: rounds in chunk_pairs
    Departure("dropped", _MESH_SCORES, "impl"),   # §C mesh layer: the mesh's devices decide
    Departure("dropped", _MESH_SCORES + _MESH_ALIGNS, "interpret"),  # §C mesh layer: likewise
    Departure("added", "*", new="device"),       # §C: every entry point takes device=
    Departure("added", "*", new="mesh"),         # §C mesh layer: a tuple of torch.device
    Departure("added", "*", new="device_walk"),  # §C mesh layer: walks on the card per shard
    Departure("added", ("native.decode_banded_native", "ops.banded.banded_align_batch"),
              new="gapped"),                     # §C: decode_banded_native takes gapped=
    Departure("added", "parallel.multihost.initialize", new="backend"),  # §C: NCCL or gloo
    Departure("fields", "utils.capabilities.DeviceCapabilities"),  # Not ported: VMEM table
]


def public_api(module) -> dict:
    """{name: parameter names} of the public functions and classes defined
    in ``module`` (``__module__`` is its name); None where ``inspect``
    finds no signature."""
    out = {}
    for name, obj in vars(module).items():
        if name.startswith("_") or not (inspect.isfunction(obj) or inspect.isclass(obj)):
            continue
        if getattr(obj, "__module__", None) != module.__name__:
            continue
        try:
            out[name] = tuple(inspect.signature(obj).parameters)
        except (TypeError, ValueError):
            out[name] = None
    return out


def differences(ref: dict, port: dict) -> set:
    """What the port lacks or changes. ``ref`` and ``port``: {module path:
    public_api}. Each difference is a tuple: ``("module", mod)``,
    ``("name", where)``, ``("removed", where, param)``, ``("added", where,
    param)`` or ``("order", where)`` (shared parameters in another order)."""
    out = set()
    for mod, names in ref.items():
        if mod not in port:
            out.add(("module", mod))
            continue
        for name, params in names.items():
            where = f"{mod}.{name}"
            if name not in port[mod]:
                out.add(("name", where))
                continue
            theirs = port[mod][name]
            if params is None or theirs is None:
                if params != theirs:
                    out.add(("order", where))
                continue
            out |= {("removed", where, p) for p in params if p not in theirs}
            out |= {("added", where, p) for p in theirs if p not in params}
            if [p for p in params if p in theirs] != [p for p in theirs if p in params]:
                out.add(("order", where))
    return out


def _covers(scope, where: str) -> bool:
    return scope == "*" or where in (scope if isinstance(scope, tuple) else (scope,))


def _explains(dep: Departure, diff: tuple, diffs: set, port: dict) -> bool:
    kind, where = diff[0], diff[1]
    if kind == "module":
        return dep.kind == "module" and dep.where == where
    if kind == "name":
        if dep.kind == "moved" and dep.where == where:
            return where.rsplit(".", 1)[1] in port.get(dep.new, {})
        return dep.kind == "name" and dep.where == where
    if kind == "order" or not _covers(dep.where, where):
        return False
    if dep.kind == "fields":
        return True
    param = diff[2]
    if kind == "removed":
        if dep.kind == "dropped":
            return dep.old == param
        return dep.kind == "renamed" and dep.old == param and any(
            ("added", where, q) in diffs for q in dep.new)
    if dep.kind == "added":
        return dep.new == param
    return dep.kind == "renamed" and param in dep.new and ("removed", where, dep.old) in diffs


def check_parity(ref: dict, port: dict, departures) -> tuple[list, list]:
    """(differences no departure explains, departures that explain none)."""
    diffs = differences(ref, port)
    unexplained = sorted(d for d in diffs
                         if not any(_explains(dep, d, diffs, port) for dep in departures))
    stale = [dep for dep in departures
             if not any(_explains(dep, d, diffs, port) for d in diffs)]
    return unexplained, stale


def _package_api(package) -> dict:
    """{module path below ``package``: public_api} for every module of it;
    private modules (the JAX package's compiled ``native._versalign_native``)
    are skipped."""
    out = {"": public_api(package)}
    prefix = package.__name__ + "."
    for info in pkgutil.walk_packages(package.__path__, prefix):
        rel = info.name[len(prefix):]
        if rel.rsplit(".", 1)[-1].startswith("_") and not rel.endswith("__main__"):
            continue
        out[rel] = public_api(importlib.import_module(info.name))
    return out


def test_port_has_every_public_name_of_the_jax_package():
    ref = _package_api(versalignlib_tpu)
    port = _package_api(versalignlib_tpu_torch)
    assert "native._versalign_native" not in ref
    assert {"ops.banded", "ops.traceback", "parallel.multihost", "utils.capabilities"} <= set(ref)
    unexplained, stale = check_parity(ref, port, DEPARTURES)
    assert unexplained == [], unexplained
    assert stale == [], stale
    # The names this check first found missing stay ported.
    assert {"banded_score_oracle", "banded_align_oracle"} <= set(port["ops.banded"])
    assert port["ops.traceback"]["decode_batch_affine"] == ref["ops.traceback"][
        "decode_batch_affine"]


def _fake(name: str, **functions) -> types.ModuleType:
    module = types.ModuleType(name)
    for fname, fn in functions.items():
        fn.__module__ = name
        setattr(module, fname, fn)
    return module


def test_checker_reports_missing_names_renames_and_stale_entries():
    def score(reads, refs, interpret=None):
        pass

    def score_port(reads, refs, device="cuda"):
        pass

    def align(reads, refs, tile=64):
        pass

    def align_port(reads, refs, tiles=64):
        pass

    def walk(records):
        pass

    ref = {"ops.fake": public_api(_fake("ref.ops.fake", score=score, align=align, walk=walk))}
    port = {"ops.fake": public_api(_fake("port.ops.fake", score=score_port, align=align_port))}
    unexplained, stale = check_parity(ref, port, [])
    assert unexplained == [
        ("added", "ops.fake.align", "tiles"), ("added", "ops.fake.score", "device"),
        ("name", "ops.fake.walk"), ("removed", "ops.fake.align", "tile"),
        ("removed", "ops.fake.score", "interpret")]
    rename = Departure("renamed", "*", "interpret", ("device",))
    stale_entry = Departure("renamed", "*", "impl", ("device",))
    unexplained, stale = check_parity(ref, port, [rename, stale_entry])
    assert ("removed", "ops.fake.score", "interpret") not in unexplained
    assert ("removed", "ops.fake.align", "tile") in unexplained
    assert stale == [stale_entry]
    # A rename explains nothing where its new name is not there, and the
    # order of the shared parameters counts.
    port = {"ops.fake": public_api(_fake("port.ops.fake", score=lambda refs, reads: None))}
    unexplained, _ = check_parity({"ops.fake": public_api(_fake("r", score=score))}, port,
                                  [rename])
    assert ("removed", "ops.fake.score", "interpret") in unexplained
    assert ("order", "ops.fake.score") in unexplained
    assert check_parity(ref, {}, [Departure("module", "ops.fake")]) == ([], [])
