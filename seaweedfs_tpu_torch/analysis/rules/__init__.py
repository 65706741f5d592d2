"""Rule registry: importing this package registers every rule with the
engine. One module per concern; see each module's docstring for the
contract it enforces and the failure mode it prevents."""
from . import (  # noqa: F401
    async_hygiene,
    cli_flags,
    context_propagation,
    device_sync,
    http_discipline,
    label_cardinality,
    lock_discipline,
    metrics_names,
    native_text,
    resource_safety,
    torch_hygiene,
)
