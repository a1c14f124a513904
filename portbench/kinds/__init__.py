"""The traffic kinds, one module a traffic file's `kind`: each
`kinds/<kind>.py` is the general generator of that kind (`inputs.py`),
found by the kind's name (`load.kind`)."""
