"""Checkpointing with an integrity manifest (``manager``)."""
