"""entropy_host_s.write: seconds a compress spends in the entropy stage
(``sz/entropy.py::encode_codes_lanes``: every lane's Huffman fit, pack,
splice, zlib and framing; its two kernels take ~1 ms of it)."""
from perfbench.measures import span_s as read  # noqa: F401

SPANS = [("repro_torch.sz.entropy", "encode_codes_lanes")]
