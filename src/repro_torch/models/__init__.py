"""The LM stack of the serving path: config, parameters, layers, GQA and
MLA attention (through the flash-attention kernel), MoE, the recurrent
blocks (mamba, mLSTM, sLSTM) and the decoder."""
