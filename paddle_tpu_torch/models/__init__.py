"""Models of the port.  ``transformer`` holds the Transformer's Fluid
builders and its paged serving form; ``sentiment`` the book's stacked
LSTM text classifier; ``fit_a_line``, ``recognize_digits`` and
``image_classification`` the book's first three chapters (the last with
the reference's ResNet-50); ``benchmark_nets`` the reference's AlexNet,
GoogLeNet and SmallNet."""
