"""The system under test, one module a configuration `backend`: each
`adapters/<backend>.py` defines `Program` (`programs.py`), found by the
backend's name (`load.adapter`)."""
