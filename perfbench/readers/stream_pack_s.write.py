"""stream_pack_s.write: seconds a streamed compress spends in the program's
`stream.pack` spans (the device stage's lane packing, `lane_bytes_batch`: the Huffman fit,
pack and per-lane zlib, on the caller's thread)."""
from perfbench import program_spans as P

P.record()


def read(run):
    return P.seconds(run, "stream.pack")
