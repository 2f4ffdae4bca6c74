"""The LM model zoo's dense decoder (port of ``repro/models``)."""
