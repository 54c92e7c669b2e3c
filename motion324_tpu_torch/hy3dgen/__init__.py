"""Shape generation (image -> mesh): the Hunyuan3D-2 flow-matching DiT, the
ShapeVAE decoder, volume decoding and marching cubes; texture generation
(mesh + image -> textured mesh): UV unwrap, the renderer and bake, the SD
VAE, UNet2p5D and multiview diffusion, PaintPipeline."""
