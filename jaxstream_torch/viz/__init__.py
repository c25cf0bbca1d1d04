"""Analysis and visualization (counterpart of :mod:`jaxstream.viz`)."""
