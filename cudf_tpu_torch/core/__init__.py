from . import dtypes  # noqa: F401
from .column import Column  # noqa: F401
from .table import Table  # noqa: F401
