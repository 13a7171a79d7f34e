"""Command-line encoder driver.

The reference CLI's surface (reference src/HEVCeMain.c:138-230):

    python -m hevce_tpu_torch <input-image> <out.h265> [qpd6 0-4] [rcon.pgm]
        [--engine=native|python] [--fast] [--device=cpu]

Arguments are order-free like the reference's: an argument that is a single
character '0'..'4' is qpd6 (default 3, src/HEVCeMain.c:153-170); the first
other argument is the input, the second the output stream, the third the
optional reconstructed-image output. Any PIL-readable input is accepted
(converted to grayscale); the reference takes only P5 PGM, and a PGM needs
no PIL.

Engines: native (default) is the C++ bit-exact engine on the host; python
is the readable spec encoder (models/encoder) with its candidates evaluated
on the device, bit-exact too; --fast is the wavefront fast mode
(models/wavefront): a compliant HEVC stream from the device's estimated
rate model, NOT bit-identical to the reference's RDO output. The python
and fast engines run on the card; --device=cpu runs them on the CPU, and
without CUDA they exit non-zero unless given it.

Prints the reference's result block (ratio / bpp / MSE / PSNR,
src/HEVCeMain.c:204-211) and the throughput.
"""
import sys
import time


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    qpd6 = 3
    engine = "native"
    device = None
    rest = []
    for a in argv:
        if len(a) == 1 and a in "01234":
            qpd6 = int(a)
        elif a == "--engine=python":
            engine = "python"
        elif a == "--engine=native":
            engine = "native"
        elif a in ("--fast", "--engine=fast"):
            engine = "fast"
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    if not 1 <= len(rest) <= 3:
        print(__doc__)
        return 1
    src = rest[0]
    dst = rest[1] if len(rest) > 1 else None
    rcon_path = rest[2] if len(rest) > 2 else None

    from hevce_tpu_torch.utils.imageio import to_grayscale, write_pgm
    from hevce_tpu_torch.utils.metrics import mse_psnr

    dev_name = "host"
    if engine != "native":
        import torch

        from hevce_tpu_torch.utils.device import resolve
        try:
            dev = resolve(device)
        except (RuntimeError, ValueError) as e:
            print(f"error: {e}")
            return 1
        dev_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu")

    try:
        img = to_grayscale(src)
    except (OSError, ValueError) as e:
        print(f"error: cannot read input image '{src}': {e}")
        return 1
    print(f"  input           : {src} ({img.shape[1]}x{img.shape[0]})")
    print(f"  qpd6            : {qpd6}  (QP = {6 * qpd6 + 4})")
    print(f"  engine          : {engine}")
    print(f"  device          : {dev_name}")

    t0 = time.time()
    if engine == "python":
        from hevce_tpu_torch.models.encoder import encode_image
        stream, rcon = encode_image(img, qpd6, device=dev)
    elif engine == "fast":
        from hevce_tpu_torch.models.wavefront import encode_image_fast
        stream, rcon = encode_image_fast(img, qpd6, device=dev)
    else:
        from hevce_tpu_torch.runtime.native import encode_image_native
        stream, rcon = encode_image_native(img, qpd6)
    dt = time.time() - t0

    if dst:
        with open(dst, "wb") as f:
            f.write(stream)
    if rcon_path:
        write_pgm(rcon_path, rcon)

    mse, psnr = mse_psnr(img, rcon)
    npix = img.size
    print(f"  stream length                   = {len(stream)} B")
    print(f"  compression ratio               = {npix / len(stream):.2f}")
    print(f"  bits per pixel                  = {8.0 * len(stream) / npix:.5f}")
    print(f"  mean square error (MSE)         = {mse:.7f}")
    print(f"  peak signal/noise ratio (PSNR)  = {psnr:.4f} dB")
    print(f"  encode time                     = {dt:.2f} s "
          f"({npix / 1e6 / dt:.3f} MP/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
