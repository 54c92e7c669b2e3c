"""Shape generation (image -> mesh): the Hunyuan3D-2 flow-matching DiT, the
ShapeVAE decoder, volume decoding and marching cubes."""
