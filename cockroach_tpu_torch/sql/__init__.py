"""The relational plan builder (Rel)."""
