"""The LM stack of the serving slice: config, parameters, layers, GQA
attention (through the flash-attention kernel) and the decoder."""
