"""Input pipeline of the port: the .npy cache and the host crop sampler.

The host mmaps the cache and gathers random uint8 HR crops (the native C++
gather where g++ builds it); the device does the float conversion, the
antialiased bicubic LR synthesis and the [-1, 1] normalization inside the
training step (``train/steps.py`` ``prepare_batch``). Only uint8 HR crops
cross host to device, from pinned memory.
"""
