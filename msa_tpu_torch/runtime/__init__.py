from msa_tpu_torch.runtime.native_lib import (  # noqa: F401
    NativeRingBuffer,
    native_available,
    pcm16_to_f32,
    slice_windows,
)
