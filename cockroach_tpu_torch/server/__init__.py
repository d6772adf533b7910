"""The SQL server surface: the pgwire protocol server."""
