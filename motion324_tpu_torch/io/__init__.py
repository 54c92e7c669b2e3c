"""Mesh, GLB and video I/O on the host (numpy; cv2/PIL imported lazily)."""
