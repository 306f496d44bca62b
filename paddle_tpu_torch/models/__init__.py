"""Models of the port.  ``transformer.PagedTransformer`` is the
encoder-decoder Transformer in its paged serving form."""
