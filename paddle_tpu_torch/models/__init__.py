"""Models of the port.  ``transformer`` holds the Transformer's Fluid
builders and its paged serving form; ``sentiment`` the book's text
classifiers (the conv net and the stacked LSTM); ``fit_a_line``,
``recognize_digits`` and ``image_classification`` the book's first
three chapters (the last with the reference's ResNet-50), ``word2vec``
and ``recommender`` its fourth and fifth; ``benchmark_nets`` the
reference's AlexNet, GoogLeNet and SmallNet; ``ctr`` wide&deep CTR
prediction over sparse embeddings; ``machine_translation`` and
``rnn_encoder_decoder`` the book's eighth chapter (seq2seq with and
without attention, beam decode in a While loop);
``label_semantic_roles`` its seventh (the deep bidirectional LSTM
scorer and the linear-chain CRF)."""
