"""render/ of the PyTorch port: the camera, the batched ray-cast RGB-D
renderer and its ray-cast kernel."""
