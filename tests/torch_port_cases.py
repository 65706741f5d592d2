"""Run a reference test module's cases on the port.

`port_cases(ref_module, **subs)` re-creates every test function and
test method of `ref_module` (and the module-level helpers they call)
with the module's globals overridden by `subs` — the reference's names
(`Entry`, `Filer`, `make_store`, ...) bound to the port's objects — so
the same assertions run unchanged against seaweedfs_tpu_torch.
-> {"Class.test_name" or "test_name": function}; a method comes bound
to an instance of its class rebuilt the same way.
`expand_params`, `run_case` and `swap_modules` cover parametrized
cases, setup/teardown methods and imports made inside a case.
"""
import contextlib
import inspect
import sys
import types


def port_cases(ref_module, skip=(), **subs) -> dict:
    g = dict(vars(ref_module))
    g.update(subs)

    def rebind(fn):
        wrapped = getattr(fn, "__wrapped__", None)
        if wrapped is not None and \
                fn.__code__.co_filename == contextlib.__file__:
            # a @contextlib.contextmanager helper: rebind what it wraps
            return contextlib.contextmanager(rebind(wrapped))
        new = types.FunctionType(fn.__code__, g, fn.__name__,
                                 fn.__defaults__, fn.__closure__)
        new.__kwdefaults__ = fn.__kwdefaults__
        return new

    for name, obj in list(g.items()):
        if isinstance(obj, types.FunctionType) and \
                obj.__module__ == ref_module.__name__ and \
                not name.startswith("test") and name not in subs:
            g[name] = rebind(obj)
    cases = {}
    for name, obj in vars(ref_module).items():
        if name.startswith("test_") and isinstance(obj, types.FunctionType):
            cases[name] = rebind(obj)
        elif name.startswith("Test") and isinstance(obj, type):
            # the class again, every method rebound (cases call their
            # class's helpers through self)
            twin = type(name, (), {
                m: rebind(fn) if isinstance(fn, types.FunctionType) else fn
                for m, fn in vars(obj).items() if not m.startswith("__")})()
            for m in vars(obj):
                if m.startswith("test_"):
                    cases[f"{name}.{m}"] = getattr(twin, m)
    return {k: v for k, v in cases.items() if k not in skip}


def call_case(fn, fixtures: dict):
    """Call a case with the fixtures its signature names."""
    return fn(*[fixtures[p] for p in inspect.signature(fn).parameters])


def expand_params(ref_module, cases: dict) -> dict:
    """-> {"name[i]": (name, kwargs)}: one entry per parameter set of a
    case the reference parametrizes (its `@pytest.mark.parametrize`),
    {"name": (name, {})} for any other case."""
    out = {}
    for name in cases:
        cls, _, attr = name.rpartition(".")
        fn = getattr(getattr(ref_module, cls), attr) if cls \
            else getattr(ref_module, name)
        marks = [m for m in getattr(fn, "pytestmark", [])
                 if m.name == "parametrize"]
        if not marks:
            out[name] = (name, {})
            continue
        (mark,) = marks
        argnames, values = mark.args[0], mark.args[1]
        names = [a.strip() for a in argnames.split(",")] \
            if isinstance(argnames, str) else list(argnames)
        for i, v in enumerate(values):
            out[f"{name}[{i}]"] = (name, dict(zip(
                names, v if len(names) > 1 else (v,))))
    return out


def run_case(fn, fixtures: dict):
    """call_case between the case's class's setup_method and
    teardown_method, as pytest runs them."""
    owner = getattr(fn, "__self__", None)
    setup = getattr(owner, "setup_method", None)
    teardown = getattr(owner, "teardown_method", None)
    if setup is not None:
        setup()
    try:
        return call_case(fn, fixtures)
    finally:
        if teardown is not None:
            teardown()


@contextlib.contextmanager
def swap_modules(mapping: dict, parents: bool = False):
    """Bind module names to other modules for the with-block, so a case
    that imports inside its body (`from seaweedfs_tpu.x import Y`) gets
    the port's module. With `parents`, each name's attribute on its
    loaded parent package is swapped too, so `from seaweedfs_tpu.pkg
    import x` gets it as well."""
    saved = {name: sys.modules.get(name) for name in mapping}
    attrs = []
    if parents:
        for name, mod in mapping.items():
            parent, _, leaf = name.rpartition(".")
            pkg = sys.modules.get(parent)
            if pkg is not None:
                attrs.append((pkg, leaf, getattr(pkg, leaf, None)))
                setattr(pkg, leaf, mod)
    sys.modules.update(mapping)
    try:
        yield
    finally:
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod
        for pkg, leaf, old in attrs:
            if old is None:
                delattr(pkg, leaf)
            else:
                setattr(pkg, leaf, old)


def within(seconds: float, fn, *args, **kwargs):
    """fn(*args, **kwargs) on a daemon thread, failing the test (never
    hanging the run) when it has not returned in `seconds` — a cluster's
    start or stop that waits on a stuck websocket subscription ends up
    here, not in the run's own time limit."""
    import threading

    out: dict = {}

    def run():
        try:
            out["value"] = fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        raise AssertionError(f"{getattr(fn, '__qualname__', fn)} did not "
                             f"return within {seconds} s")
    if "error" in out:
        raise out["error"]
    return out.get("value")
