"""Run a reference test module's cases on the port.

`port_cases(ref_module, **subs)` re-creates every test function and
test method of `ref_module` (and the module-level helpers they call)
with the module's globals overridden by `subs` — the reference's names
(`Entry`, `Filer`, `make_store`, ...) bound to the port's objects — so
the same assertions run unchanged against seaweedfs_tpu_torch.
-> {"Class.test_name" or "test_name": function}; a method comes bound
to an instance of its class rebuilt the same way.
"""
import inspect
import types


def port_cases(ref_module, skip=(), **subs) -> dict:
    g = dict(vars(ref_module))
    g.update(subs)

    def rebind(fn):
        return types.FunctionType(fn.__code__, g, fn.__name__,
                                  fn.__defaults__, fn.__closure__)

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
