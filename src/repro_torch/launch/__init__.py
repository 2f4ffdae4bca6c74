"""Training drivers and step builders (port of ``repro/launch``)."""
