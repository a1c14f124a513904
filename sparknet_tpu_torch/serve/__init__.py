"""Serving: dynamic batching, bucket padding and the serve CLI."""
