"""Serving: one replica — dynamic batching, bucket padding, checkpoint hot
reload, int8 weight-only serving, the HTTP data plane with tenant
admission, and the serve CLI."""
