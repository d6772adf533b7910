"""Columnar data: SQL types and device batches."""
