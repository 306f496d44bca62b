"""Models of the port.  ``transformer`` holds the Transformer's Fluid
builders and its paged serving form; ``sentiment`` the book's stacked
LSTM text classifier; ``fit_a_line`` and ``recognize_digits`` the book's
first two chapters."""
