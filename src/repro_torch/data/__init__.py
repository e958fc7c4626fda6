"""The data pipeline (own copy of the reference's numpy generator)."""
