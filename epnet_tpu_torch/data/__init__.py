"""The KITTI data pipeline of joint evaluation: PNG and label files,
calibration, the eval/test samples and their loader (numpy on the host)."""
