"""Utilities: tensor dataclasses, timers, safe expression evaluation,
serialization, class introspection, devices as platforms and unit strings
(counterpart of ``utils/``). ``utils.equilibration`` and ``utils.convert``
are imported by name: they reach the integrators and the models."""

from openmmtools_tpu_torch.utils.introspection import (
    find_all_subclasses,
    find_subclass,
)
from openmmtools_tpu_torch.utils.math_eval import math_eval, sanitize_expression
from openmmtools_tpu_torch.utils.platforms import (
    device_report,
    get_available_platforms,
    get_fastest_platform,
    platform_supports_precision,
)
from openmmtools_tpu_torch.utils.pytree import static_field, tensor_dataclass
from openmmtools_tpu_torch.utils.serialization import deserialize, serialize
from openmmtools_tpu_torch.utils.timing import Timer, time_it, with_timer
from openmmtools_tpu_torch.utils.units import (
    Quantity,
    is_quantity_close,
    quantity_from_string,
    temporary_directory,
    typename,
)

# the JAX package's name for the decorator of frozen tensor dataclasses
pytree_dataclass = tensor_dataclass

__all__ = [
    "Quantity",
    "quantity_from_string",
    "is_quantity_close",
    "typename",
    "temporary_directory",
    "pytree_dataclass",
    "tensor_dataclass",
    "static_field",
    "Timer",
    "time_it",
    "with_timer",
    "math_eval",
    "sanitize_expression",
    "serialize",
    "deserialize",
    "find_all_subclasses",
    "find_subclass",
    "get_available_platforms",
    "get_fastest_platform",
    "platform_supports_precision",
    "device_report",
]
