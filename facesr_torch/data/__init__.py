"""The port's input pipeline: the image decoders (JPEG, PNG, BMP, TIFF)
and the HDF5 reader and writer, the cv2 functions the pipeline uses,
paired transforms, the threaded loader, the FFHQ dataset and the native
HR-only loader (a copy of the JAX package's `facesr/data/` that needs no
cv2, PIL or h5py)."""
