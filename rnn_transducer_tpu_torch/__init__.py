"""rnn_transducer_tpu_torch — the PyTorch / CUDA port of rnn_transducer_tpu.

The JAX package beside it is the reference this port is held against. The
port mirrors its layout and names and imports neither jax nor the JAX
package. This slice covers greedy offline serving of the LSTM family:

    models/config.py      TransducerConfig, TrainConfig, NAMED_CONFIGS
    models/transducer.py  init_params, encode, predict_step, joint_step
    ops/lstm.py           lstm_cell, lstm_layer, mask_padding
    ops/lstm_cuda.py      LSTM recurrence: CUDA kernel + plain version
    csrc/lstm_fwd.cu      the kernel (CUDA C++, sm_90a)
    decode/greedy.py      greedy_decode, recognize_greedy
    serve.py              BatchingEngine, http_server, CLI
    weights.py            JAX params <-> port params, torch state dicts
    utils/build.py        nvcc build + ctypes load of csrc/
"""
