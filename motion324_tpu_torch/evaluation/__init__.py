"""Evaluation (counterpart of ``motion324_tpu/evaluation/``): geometry
metrics (Chamfer / F-score / voxel IoU with ICP, :mod:`.geometry`), video
metrics (PSNR / SSIM / LPIPS / FVD, :mod:`.video_metrics`, with I3D in
:mod:`.i3d`), CLIP similarity and DreamSim (:mod:`.clip_sim`), and the
render of animated meshes to frames through the rasterizer
(:mod:`.render_video`). Importing the package loads none of them."""
