"""Synthetic token pipeline (``synthetic.ShardedTokenStream``)."""
