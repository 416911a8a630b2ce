"""Model zoo of the port: the models the data plane is measured against (the ResNet
family for ImageNet-Parquet, ViT, MnistCNN for hello-world, and the SPMD MoE transformer
exercising dp/pp/ep/sp/tp), as torch modules and functions. Port of
``petastorm_tpu.models``; :mod:`.weights` carries the JAX models' flax variables
across. Names load lazily, as in the JAX package."""


def __getattr__(name):
    if name in ("ResNet", "ResNet18", "ResNet34", "ResNet50", "ResNet101", "ResNet152",
                "BasicBlock", "BottleneckBlock"):
        from petastorm_tpu_torch.models import resnet

        return getattr(resnet, name)
    if name in ("ViT", "ViT_S16", "ViT_B16", "ViT_L16"):
        from petastorm_tpu_torch.models import vit

        return getattr(vit, name)
    if name == "MnistCNN":
        from petastorm_tpu_torch.models.mnist import MnistCNN

        return MnistCNN
    if name in ("TransformerConfig", "init_params", "make_train_step", "param_shardings",
                "model_mesh", "data_sharding", "reference_loss"):
        from petastorm_tpu_torch.models import transformer

        return getattr(transformer, name)
    if name in ("load_flax_variables", "flax_variables"):
        from petastorm_tpu_torch.models import weights

        return getattr(weights, name)
    raise AttributeError("module 'petastorm_tpu_torch.models' has no attribute %r" % name)
