"""The ImageNet amp example (counterpart of ``examples/imagenet``)."""
