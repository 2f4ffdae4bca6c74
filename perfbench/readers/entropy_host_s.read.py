"""entropy_host_s.read: seconds a whole-field decode spends parsing its
lanes (each predictor's ``parse_lane``: zlib, the Huffman tables, the
upload and the per-lane decode launch, and interp's outliers)."""
from perfbench.measures import span_s as read  # noqa: F401

SPANS = [("repro_torch.sz.predictor", "_LorenzoTiles.parse_lane"),
         ("repro_torch.sz.predictor", "_InterpTiles.parse_lane")]
