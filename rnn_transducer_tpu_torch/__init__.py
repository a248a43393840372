"""rnn_transducer_tpu_torch — the PyTorch / CUDA port of rnn_transducer_tpu.

The JAX package beside it is the reference this port is held against. The
port mirrors its layout and names and imports neither jax nor the JAX
package. Its slices: greedy offline serving and the training step of the
LSTM family, the loss lattice and the two-pass loss on the card, int8
serving and greedy decode in one launch, and the offline conformer
encoder, served and trained; beam search, streaming sessions, and raw
audio in, text out (the log-mel frontend, tokenizers, word segments,
checkpoints served by directory and the decode CLI). Entry points run on
the card unless the caller asks for the CPU.

    models/config.py      TransducerConfig, TrainConfig, NAMED_CONFIGS
    models/transducer.py  init_params, encode, predict_step, joint_step,
                          predict, joint, joint_activations, forward
    ops/conformer.py      init_conformer_block, conformer_block
    ops/fused_ln.py       fused LayerNorm (± silu): kernels + plain versions
    ops/lstm.py           lstm_cell, lstm_layer, LSTMCore, mask_padding
    ops/lstm_cuda.py      LSTM recurrence fwd / bwd: kernels + plain versions
    ops/rnnt_loss.py      RNN-T loss, alpha / beta, occupancies
    ops/rnnt_joint_fused.py  fused joint + loss: kernels + plain versions
    ops/logmel.py         log_mel (on the audio's device), log_mel_oracle
    csrc/*.cu             the kernels (CUDA C++, sm_90a)
    data/synthetic.py     random_batch, learnable_batch
    data/pcm_stream.py    PcmFeaturizer (chunked PCM, exact)
    data/tokenizer.py     char / phone / BPE tokenizers and their meta
    data/manifest.py      manifest examples (audio through log_mel)
    decode/words.py       word segments; decode/metrics.py WER, RTF
    decode/greedy.py      greedy_decode, recognize_greedy
    serve.py              BatchingEngine, http_server, CLI
    recognize.py          decode / eval CLI
    train/loop.py         TrainState, init_train_state, make_train_step
    train/checkpoint.py   save_checkpoint, restore_checkpoint, latest_step
    train/__main__.py     training CLI
    weights.py            JAX params <-> port params, torch state dicts
    utils/build.py        nvcc build + ctypes load of csrc/
"""
