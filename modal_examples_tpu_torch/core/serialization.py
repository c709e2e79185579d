"""Serialization of args/results across the client -> container boundary,
after ``modal_examples_tpu/core/serialization.py``.

Results, arguments, exceptions and :class:`RemoteError` go as the JAX
package sends them: pickle, with the remote traceback beside an exception
and a :class:`RemoteError` shim for one that does not survive a round trip.

Callables differ. The JAX package ships every function through
``cloudpickle``. The port ships a module-level function or class **by
reference**: the module's name, the object's qualified name and the module's
file. The container imports that module, as the reference's containers
import the user's module (SURVEY.md §3.1); an app file loaded by path
(``core/app.py`` ``load_module_from_path``) is imported there under the same
name, from the source directory ``FunctionSpec`` ships. Only a callable that
no import can find (a closure, a lambda, one defined in ``__main__``) goes by
value, through ``cloudpickle``, which is imported for that alone; without it
such a callable raises :class:`SerializationError` naming it.
"""

from __future__ import annotations

import importlib
import io
import pickle
import sys
import traceback
from typing import Any


class SerializationError(Exception):
    pass


class RemoteError(Exception):
    """A user exception re-raised on the client, with the remote traceback."""

    def __init__(self, message: str, remote_traceback: str = ""):
        super().__init__(message)
        self.remote_traceback = remote_traceback

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        base = super().__str__()
        if self.remote_traceback:
            return f"{base}\n--- remote traceback ---\n{self.remote_traceback}"
        return base


def _cloudpickle(what: str):
    try:
        import cloudpickle
    except ImportError:
        raise SerializationError(
            f"{what} can only go by value, which needs the 'cloudpickle' "
            "package, and it is not installed; define it at module level so "
            "it goes by reference"
        ) from None
    return cloudpickle


def serialize(obj: Any) -> bytes:
    """Pickle ``obj``; cloudpickle for what plain pickle cannot send."""
    try:
        return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    except Exception as first:
        cloudpickle = _cloudpickle(f"a {type(obj).__name__!r} value")
        try:
            return cloudpickle.dumps(obj)
        except Exception as e:
            raise SerializationError(
                f"cannot serialize {type(obj).__name__!r} for the remote boundary: {e}"
            ) from first


def deserialize(data: bytes) -> Any:
    return pickle.loads(data)


def serialize_exception(exc: BaseException) -> bytes:
    """Best-effort pickle of the exception itself; else a RemoteError shim."""
    tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
    try:
        payload = pickle.dumps((exc, tb), protocol=pickle.HIGHEST_PROTOCOL)
        # Verify round-trip: some exceptions pickle but fail to unpickle.
        pickle.loads(payload)
        return payload
    except Exception:
        shim = RemoteError(f"{type(exc).__name__}: {exc}", tb)
        return pickle.dumps((shim, tb), protocol=pickle.HIGHEST_PROTOCOL)


def deserialize_exception(data: bytes) -> tuple[BaseException, str]:
    exc, tb = pickle.loads(data)
    return exc, tb


class ByReference:
    """A module-level callable named by its module and qualified name; the
    container imports the module (from ``path`` under the same name when
    the module is not importable by name there) and looks the name up. A
    name that the module's decorators rebound to a handle (``Function``,
    ``Cls``, ``ServerHandle``) resolves to the user's callable inside it."""

    def __init__(self, module: str, qualname: str, path: str | None):
        self.module, self.qualname, self.path = module, qualname, path

    def resolve(self) -> Any:
        mod = sys.modules.get(self.module)
        if mod is None:
            try:
                mod = importlib.import_module(self.module)
            except ImportError:
                if not self.path:
                    raise
                from .app import load_module_from_path

                mod = load_module_from_path(self.path, name=self.module)
        obj = mod
        for part in self.qualname.split("."):
            obj = getattr(obj, part)
        return _unwrap(obj)

    def __repr__(self) -> str:
        return f"ByReference({self.module}.{self.qualname})"


def _unwrap(obj: Any) -> Any:
    """The user's function or class behind a decorator handle."""
    for attr in ("raw_f", "_user_cls"):
        if hasattr(obj, attr) and not isinstance(obj, type):
            return getattr(obj, attr)
    inner = getattr(obj, "_cls", None)  # ServerHandle -> Cls -> class
    if inner is not None and hasattr(inner, "_user_cls"):
        return inner._user_cls
    return obj


def _reference(obj: Any) -> ByReference | None:
    """A by-reference name for ``obj`` when importing its module finds it."""
    module = getattr(obj, "__module__", None)
    qualname = getattr(obj, "__qualname__", None)
    if not module or not qualname or module == "__main__" or "<" in qualname:
        return None
    mod = sys.modules.get(module)
    if mod is None:
        return None
    found = mod
    try:
        for part in qualname.split("."):
            found = getattr(found, part)
    except AttributeError:
        return None
    if found is not obj and _unwrap(found) is not obj:
        return None
    return ByReference(module, qualname, getattr(mod, "__file__", None))


def function_to_bytes(target: Any) -> bytes:
    """Serialize a callable definition for execution inside a container:
    a function, or a ``(class, lifecycle meta)`` pair for a Cls. Module-level
    callables go by reference; the rest by value through cloudpickle."""
    if isinstance(target, tuple):
        head, *rest = target
        ref = _reference(head)
        if ref is not None:
            try:
                return pickle.dumps((ref, *rest), protocol=pickle.HIGHEST_PROTOCOL)
            except Exception:
                pass  # the lifecycle meta holds something only cloudpickle sends
    else:
        ref = _reference(target)
        if ref is not None:
            return pickle.dumps(ref, protocol=pickle.HIGHEST_PROTOCOL)
    name = getattr(target[0] if isinstance(target, tuple) else target, "__qualname__", repr(target))
    cloudpickle = _cloudpickle(f"{name!r} (not importable by name)")
    buf = io.BytesIO()
    cloudpickle.dump(target, buf)
    return buf.getvalue()


def function_from_bytes(data: bytes) -> Any:
    target = pickle.loads(data)
    if isinstance(target, ByReference):
        return target.resolve()
    if isinstance(target, tuple) and target and isinstance(target[0], ByReference):
        return (target[0].resolve(), *target[1:])
    return target
