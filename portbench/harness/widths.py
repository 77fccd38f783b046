"""The declared width of each column type, in bytes: what a byte count
charges for a value, whatever layout the program keeps it in. A string
column is its int32 dictionary code; a nullable column adds one bit a row
(an Arrow validity bitmap)."""

WIDTH = {"int64": 8, "float64": 8, "timestamp[ns]": 8, "int32": 4, "float32": 4,
         "string": 4}


def column_width(spec: dict, column: str) -> int:
    for table in spec["tables"].values():
        if column in table["columns"]:
            return WIDTH[table["columns"][column]]
    raise KeyError(f"no column {column!r} in the configuration")
