from .series import Series
from .dataframe import DataFrame, concat
from .groupby import DataFrameGroupBy

__all__ = ["Series", "DataFrame", "DataFrameGroupBy", "concat"]
