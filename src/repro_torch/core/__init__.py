"""GWLZ core: grouping, the group-wise enhancer, its trainer and the
compress/decode pipeline (port of ``repro/core``)."""
