from .sharding import DEFAULT_RULES, Sharder

__all__ = ["DEFAULT_RULES", "Sharder"]
