"""Device ops: two-stage JPEG decode (:mod:`.jpeg`, kernel K1), image normalisation
(:mod:`.image`, kernel K2), the device shuffle ring (:mod:`.device_shuffle`), the
declarative feature pipelines (:mod:`.tabular`), the CUDA kernel build (:mod:`.kernels`)
and the host entropy decoder (:mod:`.native`). Nothing builds at import."""


def __getattr__(name):
    if name in ("normalize_images", "normalize_and_augment", "random_crop"):
        from petastorm_tpu_torch.ops import image

        return getattr(image, name)
    if name == "DeviceShuffleBuffer":
        from petastorm_tpu_torch.ops.device_shuffle import DeviceShuffleBuffer

        return DeviceShuffleBuffer
    if name in ("idct_blocks", "decode_jpeg_device_stage", "ycbcr_to_rgb",
                "entropy_decode_jpeg_fast", "decode_jpeg_batch"):
        from petastorm_tpu_torch.ops import jpeg

        return getattr(jpeg, name)
    if name in ("FeaturePipeline", "Normalize", "Standardize", "Clip", "Cast",
                "FillNull", "Bucketize", "HashField", "VocabLookup",
                "FeatureCross", "PipelineValidationError"):
        from petastorm_tpu_torch.ops import tabular

        return getattr(tabular, name)
    raise AttributeError("module 'petastorm_tpu_torch.ops' has no attribute %r" % name)
