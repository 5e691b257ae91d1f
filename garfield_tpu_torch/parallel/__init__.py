"""Training topologies of the port (counterpart of ``garfield_tpu/parallel``):
the shared core (``core``), the folded attack+GAR path (``fold``) and the
AggregaThor single-server trainer (``aggregathor``)."""
